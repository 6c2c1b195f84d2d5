"""Cost and roofline accounting of the dry run (counterpart of ``repro/analysis``)."""
