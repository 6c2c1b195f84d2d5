#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--phases 1,2,12]

``--phases`` runs the named phases, the ones they need and 1 and 2 (the
kernels line, phase 18, only on a full run); by default every phase runs
once.  Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository's ``src/`` next to this file; imports nothing of JAX.  Phases,
each fatal on error (nothing is caught, nothing falls back to the CPU or
to a plain version):

  1. the card's name and power limit (``nvidia-smi``);
  2. build every CUDA source of the port (one ``nvcc`` each, in parallel)
     and print ``ptxas``'s registers and spills: every source must spill 0
     bytes (``expert_ffn_grouped`` and ``expert_ffn`` share
     ``ffn_tile.cuh``'s up and down kernels);
  3. hold each of the seven kernels against its plain PyTorch version on
     the card at the serving and training paths' shapes (plus a duplicate-
     slot dispatch, a partial-tile ragged FFN and bf16 cases), check the
     fp8 wire codec's bytes on the card against the CPU's, and time kernel,
     plain version, the bound (bytes at 3.35 TB/s or flops at the type's
     peak, whichever is larger) and, as a yardstick the port never calls,
     ``torch.nn.functional.rms_norm`` / ``scaled_dot_product_attention`` /
     ``torch.index_add`` / ``torch.nn.functional.embedding_bag`` (held to
     the plain combine within its tolerance first); dispatch's and
     combine's rows also log the device time alone (the calls replayed
     from a CUDA graph), cold and L2-warm;
  4. serve full-width qwen3-moe-30b-a3b cut to 4 layers (random weights
     from a seed) through ``Engine``: 16 requests, some sharing a 32-token
     prefix, once one-shot, once with 32-token prefill chunks and once
     one-shot under the ``s1d`` schedule; each run's kernels' launch counts
     must be > 0; one-shot under ``s1d`` must give one-shot's tokens for
     every request; then once one-shot and once chunked at the drop-free
     capacity factor (n_experts / top_k), which must agree for every
     request (at the config's own factor the prefill pools' drops depend
     on the chunking, as in the JAX engine: logged, not asserted); one
     request's logits are checked against a reference forward with the
     plain versions swapped in, under both schedules;
  5. serve the same requests forward and in reversed arrival order (prefix
     cache off, so each request's prefill is the same computation in both
     runs): every request's greedy tokens must be identical;
  6. one gpt2-moe MoE layer at full width (8 x 1024 tokens) under
     baseline, s1, s2, s2h, s1d, s1_pipe, s2_pipe (2 chunks) and s1g:
     bitwise equal to each other (the grouped kernel runs the dense
     path's FMA chains), within 1e-4 of the same layer with the plain
     versions; each schedule's forward timed;
  7. train full-width qwen3-moe-30b-a3b cut to 4 layers, batch 1 x 2048
     ``SyntheticLM`` tokens: the first step taken twice from the same
     parameters, AdamW state and batch must give ``torch.equal`` parameters
     and moments (no deterministic flag, no ``CUBLAS_WORKSPACE_CONFIG``),
     and the first step of ``make_guarded_train_step`` (lr_scale 1.0,
     grad_fault 0.0, the fp8 monitor on) from the same seed must give
     ``torch.equal`` parameters, moments and step counter and the same
     loss bits as the plain step; loss and gradient norm of one step with
     the kernels against one with the plain versions from the same
     parameters, then AdamW steps through ``Trainer``: every loss finite,
     the last three below the first, launches per step as predicted;
     under the default schedule (s1g, 10 steps) and under s1g with the
     fp8 wire (5 steps);
  8. the same for gpt2-moe at its full size (12 layers), batch 8 x 1024,
     5 steps, under the default schedule and under s1 with 2 chunks
     (layernorm: no rmsnorm launches);
  9. guarded training: gpt2-moe at full width cut to 4 layers (2 MoE
     layers; checkpoints of both moments are 1.6 GB, not 12 layers' 3.9),
     batch 8 x 1024, s1g with the fp8 wire, checkpoints in a temporary
     directory.  (a) ``nan_grad@step=3-5;ckpt_bitflip@save=2``, max_skips
     2, a snapshot every 2 steps, 2 retained, 10 steps: the exact counters
     and events (the NaN cotangents saturate the fp8 encodes, so the fp8
     fallback fires at step 3; the rollback at step 4 skips the corrupt
     step-2 file and restores step 0), a finite last loss;
     (b) save, one step, restore in place, the same step again: ``torch.
     equal``, with each save's and restore's seconds and GB/s; (c)
     ``fp8_sat@factor=64``: the fallback fires after step 0, the ragged
     path (dispatch, ``expert_ffn_ragged``, combine) launches in step 0
     only and ``expert_ffn_grouped`` from step 1 on, each at the per-layer
     counts of phases 7 and 8, every loss finite; (d) ms per step of the
     plain and the guarded clean loop and the guarded loop with a
     telemetry sink, three runs each, in turns;
 10. serving under faults, deadlines and sheds, and the telemetry; (a)-(e)
     run right after phase 5 on its model and prompts (prefix cache off,
     one request per prefill call; phase 5's forward run is the fault-free
     reference): (a) ``PHASE10_FAULTS`` with a 6-round watchdog: request 1
     expired by its tick budget, request 2 evicted by the watchdog, the
     other 14 phase 5's tokens exactly, the pages balanced, its launches
     the path ``serve_chaos``; (b) a 1e-6 s deadline expires 3 requests;
     (c) a 2-block arena sheds a request for blocks beside one that
     finishes, one row with a ~0 queue SLO sheds the waiting request;
     (d) the fault-free run with the knobs on (watchdog, 60 s deadline and
     queue SLO, a JSONL sink) against the plain run, three each in turns,
     tok/s and p50/p99, every run phase 5's tokens; (e) that sink's
     events: each request's lifecycle in order, one ``decode_round`` per
     round, the rollup's p50 the quantile of the finished latencies.
     (f) rides on phase 9 (a): a sink installed, its guard events exactly
     ``GuardState.events``, ``fp8_sat`` events at step 3 with their step,
     MoE call, schedule and wire; and 9 (d) times the sink.  (g) follows
     phase 6: stage traces of its layer under s1 and s1g
     (``obs.audit.trace_schedule``'s harness, CUDA events): the plan's
     stages, a Chrome JSON that loads, the output ``torch.equal`` before
     and after the timer, per-stage ms beside phase 6's forward; their
     launches the paths ``trace_gpt2_moe_s1`` and ``trace_gpt2_moe_s1g``;
 11. the cost model and the autoscheduler: (a) ``fit_perfmodel``'s two
     fits on the card (``expert_ffn``'s rate, the one-rank wire stage's
     startup), each R^2 > 0.8, beside ``h100_model``'s data-sheet figures;
     (b) analytic decisions under both models at qwen3's decode pool, its
     prefill buckets and 1 x 2048 training layer and gpt2-moe's 8 x 1024:
     each ``s1g`` x1 f32; (c) measured decisions at gpt2-moe's layer,
     qwen3's training layer and its decode pool: every candidate finite,
     printed sorted beside phase 6's forward times, a second ``decide``
     the same object with no launch (paths ``autosched_measure_*``); (d)
     gpt2-moe (12 layers, 8 x 1024) trained 3 steps under
     ``autosched="measured"`` and an ``auto`` wire with a sink: parameters
     and moments ``torch.equal`` to the run forced to the pick, the same
     ``moe_call`` state per step and fp8 counts, one
     ``autosched_decision`` event (path ``train_gpt2_moe_measured``); (e)
     (right after phase 10 (a)-(e)) phase 4's model and 16 requests served
     one-shot under ``autosched="measured"``: phase 4's tokens, the
     decisions printed (path ``serve_measured``); (f) the schedule audit
     of gpt2-moe's layer under s1, s2 and s1g with the fitted model:
     per-stage predicted and measured ms, ``worst``, ``time_scale``; (g)
     ``suggest_max_batch`` for phase 4's serving under both models, and
     the serve launcher with ``--max-batch 0``;
 12. Parm's schedules across ranks: ranks spawned on ``cuda:0`` over
     gloo (one card; NCCL refuses two ranks on one card), the kernels
     built once before.  (a) one gpt2-moe MoE layer at full width, 8 x
     1024 global tokens at the drop-free capacity factor E / k = 4, on the
     distinct ``(ep=2, esp=2, mp=2)`` mesh (8 ranks) under baseline, s1,
     s2 and a 4-token decode pool (the ``dense_decode`` fallback), and on
     the merged ``(data=2, model=2)`` mesh (4 ranks) under baseline, s1,
     s2, s2h, s1_seqpar, s1g (the pool form: counts AlltoAll, ragged
     kernel), s1_pipe and s2_pipe (2 chunks), bf16 and fp8 wires under s1
     and s1g: each rank's output and gradient blocks (of sum(y * r)) held
     to the one-rank s1g layer's (``P12_WIRE`` on a bf16 / fp8 wire),
     expert_load to its routed rows exactly (times the schedule's gate
     multiplicity), each path's kernels launched on every rank, each
     case's host ms and collective seconds, and on the merged mesh the
     forward collectives of baseline, s1, s2 and s1_seqpar (kind, group,
     count, result bytes) on every rank equal to the paper's Eq. 1, 11
     and 14 at N_EP = 2, N_ESP = N_MP = 2
     (``expected_volumes``); (b) in the same 4-rank spawn,
     gpt2-moe (cut to 2 layers, ``P12_TRAIN_LAYERS``; 8 x 1024 global,
     factor 4) trained 3 steps on
     the merged mesh under s1 and s2 (``P12_TRAIN_SCHEDS``): every step's
     loss within 1e-4 and gradient norm within 1e-3 of the one-rank run
     from the same state, the first step taken twice ``torch.equal`` on
     every rank; (c) ms per step and each collective's host share, per
     rank (gloo through the host, not NCCL); (b)-(c) run under Megatron
     tensor parallelism of the dense layers over ``model`` (attention by
     head, the FFN column / row; gpt2-moe's odd vocabulary stays whole);
     (d) in the same spawn, one qwen3-moe-30b-a3b block at full width
     with the LM head and CE at the full 151936 vocabulary (vocab-
     parallel), 1 x 2048 tokens a data rank, forward and backward through
     ``Model.loss`` under s2 on (data=2, model=2) (16 query and 2 kv
     heads a rank) and on (data=1, model=4) (8 and 1), against one-rank
     runs over the same pools on the card: loss within 1e-4, the
     backbone's output rtol 2e-4 / atol 2e-5, every gradient within 2e-4
     of its largest entry, the routed rows exact, each rank's
     ``flash_attention`` and ``rmsnorm`` launches counted; (e) in the
     same spawn, phase 9 (a)'s guarded run across the four ranks
     (``p9_config``: 4 layers, s1g, the fp8 wire, 8 x 1024 global tokens
     on (data=2, model=2), ``PHASE9_FAULTS``, max_skips 2, a snapshot
     every 2 steps, 2 retained, 7 steps, rank 0's sink): on every rank
     exactly ``PHASE9_EVENTS`` and ``PHASE9_COUNTERS`` (7 steps), the
     store's history (the rollback at 4 onto the step-0 file past the
     corrupt step-2 file), NaN losses at steps 3-5 and the finite ones
     within ``P12_GUARD_RTOL`` of phase 9 (a)'s (made on one rank here
     when phase 9 did not run), rank 0's stream with the guard events and
     every rank's ``fp8_sat`` at step 3 (their ``sat`` the world
     counter's), the step-6 file restored into fresh tensors on every
     rank ``torch.equal`` to the live shards and loaded on one rank in
     the parent; each rank's launches, the guarded ms/step, the agreement
     all-gathers' share, each snapshot's gather and write seconds and
     each rank's restore seconds; (f) the launcher's ``--profile`` there:
     one clean guarded step profiled on every rank, rank 0's busy share
     over (e)'s last step (a clean guarded step) as the unprofiled wall;
     (g) in the same spawn, (d)'s block and weights served on (data=2,
     model=2) through ``Engine(model, mesh, dims)`` at the drop-free
     capacity factor (``p12_serve_cfg``): 8 requests of 17-64 tokens,
     four sharing a 32-token prefix, 8 tokens each, max batch 8, pages of
     16, under ``auto``, ``s1d`` forced and ``autosched="measured"``:
     on every rank every request complete, a prefill call per admission,
     every page back, a decode decision, the plan agreed once a tick,
     each request's first logits rtol 2e-4 / atol 2e-5 of rank 0's
     one-rank engine (served in its turn of (d) with the whole model)
     and its stream that engine's, a difference allowed only at a step
     whose one-rank top-2 gap is within that tolerance (printed and
     counted); tok/s, p50 / p99 and each collective's share per rank;
     (h) on (a)'s merged layer, ``decide`` measured over s1, s2, s1g and
     s2h on the live mesh, then the pick with an ``"auto"`` wire measured
     through ``apply_moe``: the same times and picks on every rank, the
     output ``torch.equal`` to the pick forced; (i) expert placement in
     the same spawn: (a)'s merged layer under s1 and s1g (f32, forward
     and backward) with ``p12_placements`` (identity: output, aux and
     every gradient ``torch.equal`` to (a)'s unplaced run of the
     schedule; rep2, every expert twice at half capacity, and hot, expert
     0 on every spare slot: (a)'s tolerances, the drop mask,
     ``expert_load`` and ``drop_frac`` exact), the weights' exchange
     bytes and host ms; (b)'s gpt2-moe under ``auto`` with
     ``placement="auto"``, ``rebalance_every=1``, 4 steps, the gate
     skewed toward expert 0 (``P12_PLACED_SKEW``): a ``train_rebalance``
     event with one placement on every rank, ``h100_model``'s modeled
     times, finite losses, those before the swap equal to an unplaced
     run's, the placed kernels launched after the swap; (g)'s requests
     under ``auto`` with the two experts rank 0's one-rank prefill routed
     most replicated (R = 130, installed by ``autosched.set_placement``):
     (g)'s checks, and which pools ran the placement; each sub-phase's
     seconds; (j) in the same spawn, right after (a), the overlapped issue
     of the layer's collectives (``executor.execute``'s list scheduler)
     on (a)'s merged layer under ``P12_OVERLAP`` (s1, s2, s2h and
     s1g with 2 chunks, s2 with SAA at 4 chunks, f32, and s1 with 2
     chunks on the fp8 wire), forward and backward, against its serial
     twin (``executor.serial_issue``): on every rank y, aux and every
     gradient ``torch.equal``, two or more collectives in flight in the
     overlapped forward (``comm.set_hook``'s record; one in the serial),
     and in the backward of s1 with 2 chunks and of s2, each path's
     kernels launched; per rank the best of 3 runs of each mode (after
     (a)'s warm-up; (a)'s runs of s1_pipe2, s2_pipe2 and s2 are the
     overlapped side's first): host ms, the collectives' summed seconds
     and their in-flight wall seconds (``comm.timing``); (k) last in the
     same spawn, the KV-cache serve path: mistral-nemo-12b at full width
     cut to 4 layers (``p12_kv_cfg``), each rank's Megatron shards made
     in turn, ``prefill_step`` and greedy ``make_serve_step`` steps through
     the cache on (data=2, model=2) for ``P12_KV_CASES`` (B=1 with a
     16384-token prompt and 16 tokens; B=2, the batch over data, 16
     tokens), each with ``cache_specs(seq_shard=False)`` (the kv heads
     over model, W whole) and ``True`` (W over data x model, or over
     model): on every rank the tokens of a one-rank reference made before
     the spawn, logits as near an f64 witness of the teacher-forced
     logits (``logits_f64``) as the one-rank run's (``P12_KV_EXACT_RATIO``;
     2e-5 + 2e-4 |w| of the one-rank logits logged), the split-W logits
     within that of the whole-W run's, the W-sharded K/V 1/nw of every
     head and slot of its rows, a decode
     step's collectives per kind (calls, bytes) the same on a cache of 2W
     (no K or V crosses ranks), flash once a layer of the prefill and
     rmsnorm 2 a layer + 1 a call; each layout's seconds, tok/s, K/V MB
     and per rank the bytes and host ms a decode step of each collective;
     (l) last, the recurrent kinds Megatron-split over model (``P12_RZOO``:
     hymba-1.5b at full width cut to 4 layers, its attention in the
     gathered-heads layout and its Mamba cell on half of d_inner a rank;
     xlstm-350m cut to one ``[mlstm x 7, slstm]`` group, the mLSTM cell on
     2 of 4 heads a rank, the sLSTM whole on every rank), held to one-rank
     runs on the card made before the spawn (``_p12_rzoo_reference``;
     each rank makes its parameters from the seed): one
     ``make_train_step`` step (1 x 2048 and 1 x 512 a data rank), loss
     within 1e-4, each rank's gradient shard within 2e-4 of its leaf's
     largest entry, the leaves replicated over model bitwise equal across
     MP; 16 teacher-forced ``decode_step`` steps of 8 rows a data rank,
     logits rtol 2e-4 / atol 2e-5 and every state shard
     (``cache_specs``' layout) within 2e-4 of its leaf's largest entry;
     rmsnorm and flash launches per rank as ``rzoo_launches`` predicts
     (paths ``train_hymba_mesh``, ``decode_hymba_mesh``,
     ``train_xlstm_mesh``, ``decode_xlstm_mesh``, also in ``by_path``
     with rank 0's launches); each collective's bytes a step per rank,
     seconds, decode ms a step and peak memory a rank; (m) last, the
     cross-attention kinds Megatron-split over model (``P12_XZOO``:
     llama-3.2-vision-11b at full width cut to one ``dense`` and one
     gated ``cross`` layer, 16 / 4 heads a rank; whisper-tiny whole, its
     encoder and ``xdec`` layers at 3 of 6 heads a rank), the gates at
     ``XZOO_GATES``, held to one-rank runs on the card made before the
     spawn (``_p12_xzoo_reference``): one ``make_train_step`` step (1 x
     2048 over 1601 context embeddings and 8 x 448 over 8 x 1500 frames a
     data rank), loss within 1e-4, each rank's gradient shard within 2e-4
     of its leaf's largest entry, the leaves replicated over model bitwise
     equal across MP; ``Model.ctx_kv`` over 8 rows a data rank (this
     rank's kv heads) and 16 teacher-forced ``decode_step`` steps through
     it, logits rtol 2e-4 / atol 2e-5; rmsnorm and flash launches per
     rank as ``xzoo_launches`` predicts (paths ``train_vision_mesh``,
     ``decode_vision_mesh``, ``train_whisper_mesh``,
     ``decode_whisper_mesh``, also in ``by_path``); each collective's
     bytes a step per rank, seconds, ``ctx_kv``'s MB and seconds, decode
     ms a step and peak memory a rank;
 13. the five configs whose block kinds the port runs, each at full width
     with random weights from a seed, freed before the next, its peak
     device memory logged: (a) llama4-scout-17b-a16e cut to 4 layers (3
     chunked local ``moe`` layers, 1 NoPE ``moe_full``) serving phase 4's
     16 requests one-shot and with 32-token chunks under ``auto`` (the
     log names auto's pick for the decode pool: ``s1g``, the grouped
     kernel) and one-shot under ``s1d``, each path's kernels launched,
     one request's logits through ``reference_check``; (b) one 8256-token
     request (8192 + 64: across the 8192-token chunk) at the drop-free
     capacity factor 16, prefilled through ``paged_step`` in 512-token
     chunks: its last logits within 1e-3 of the logits' scale of
     ``Model.forward`` over the same tokens (the training path's chunk
     mask, ``sdpa_flash_scan``) with the same greedy token, the forward
     with the chunk widened past the request more than that apart, and
     the engine (512-token chunks) serving that greedy token first;
     command-r-35b (4 layers: layernorm, the parallel block, the tied
     256000-row head times ``logit_scale``; no kernel launches, as in
     JAX), yi-9b and mistral-nemo-12b (4 layers each) serving the 16
     requests one-shot under ``reference_check``; qwen1.5-0.5b at its
     full size (24 layers, MHA with the qkv bias, tied embedding) served
     so, then trained 5 steps at 1 x 2048 ``SyntheticLM`` tokens as phase
     7 trains (the first step kernels vs plain versions, twice bitwise
     and once guarded; finite losses, the last three below the first,
     ``rmsnorm`` and ``flash_attention`` launches per step as predicted);
     (c) after mistral-nemo's serving, the KV-cache serve path on it
     (``zoo_kv_cache``): ``prefill_step`` over 4 right-padded prompts of
     1024-2048 tokens (``ZOO_KV_LENS``) and 32 greedy ``make_serve_step``
     steps, each row at its own position (flash once a layer, rmsnorm 2 a
     layer + 1 a call, path ``serve_mistral_nemo_cache``); every step's
     logits within ``ZOO_KV_TOL`` of the scale of ``Model.forward``'s over
     the same tokens, the greedy tokens equal; the
     paged engine on the same prompts, its streams counted against these
     and both tok/s logged;
 14. the dry run (``repro_torch.launch.dryrun``): (a) ``dry_one``
     (the CLI's ``--arch qwen3-moe-30b-a3b --shape train_4k``) traced as
     rank 0 of the 16x16 production mesh on the meta device (the fake
     ``torch.distributed`` backend), and (b) ``--shape decode_32k
     --cache-seq-shard``, then (a) hymba-1.5b ``long_500k`` and
     xlstm-350m ``decode_32k`` (the shapes of JAX's records of them; the
     Mamba cell split, the mLSTM cell in the gathered-heads layout over
     MP 16, the sLSTM replicated) and llama-3.2-vision-11b and
     whisper-tiny ``decode_32k`` (2 query heads a rank over one
     replicated kv head; whisper's 6 heads in the gathered-heads layout
     over MP 16; ``ctx_kv`` an argument, as JAX lowers it), on a thread of this process (with (c)'s
     one-rank reference and qwen1.5's meta record) while (c)'s ranks
     run: per rank the parameters, moments, batch / cache,
     temporaries and total GB, ``fits_80gb``, the roofline's three terms
     (modeled from the H100 SXM's data sheet, not measured), the
     collective bytes by kind and ``trace_s``; the records' keys and sums
     checked; (c) the dry run's real runs, 8 gloo ranks on the 4x2 test
     mesh sharing the card at float32 (``dryrun.run_rank``, the ranks
     built once before): gpt2-moe ``--run-step --guards`` (reduced, 8 x
     64 tokens, the drop-free capacity factor) within 1e-4 of one rank's
     ``make_train_step`` on the card with ``nonfinite`` 0, and reduced
     qwen1.5-0.5b's ZeRO-1 step (moments over ``data``) ``torch.equal``
     to the whole-moment step on every rank, each rank's moment bytes the
     meta record's, then on the same ranks the schedule_comparison example
     (``repro_torch.examples.schedule_comparison.compare``: one MoE layer
     of ``d_model`` 256 over x (8, 512, 256) under baseline, s1, s2,
     s1_seqpar, s1 and s2 with 4 chunks, and auto, ``P14_COMPARISON_ITERS``
     timed calls a row): on every rank ``max|y - y_base|`` 0 for the
     rows that gate the baseline's pool (``P14_COMPARISON_EXACT``), within
     ``P14_COMPARISON_ATOL`` for the rest, and baseline's, s1's, s2's and
     s1_seqpar's collectives by kind
     and group, counts and result bytes, equal to the paper's Eq. 1, 11
     and 14 (``expected_volumes``, with the aux means and s1_seqpar's
     output gather the port's layer moves beside the plan); each kernel's
     launches per rank (paths ``dryrun_4x2_gpt2_moe``,
     ``dryrun_4x2_qwen1.5_zero1`` and ``comparison_4x2``); the phase's
     seconds beside ``P14_LIMIT_S``;
 15. the recurrent zoo: hymba-1.5b (32 hymba layers: attention with a
     1024-token window and 25 / 5 heads beside a Mamba head) and
     xlstm-350m (24 layers, an sLSTM every 8th among mLSTMs) at full
     size, random weights from a seed, each freed before the next: (a)
     ``RZOO_ROWS`` rows, ``RZOO_PROMPT`` prompt tokens through
     ``decode_step`` and ``RZOO_GEN`` greedy ``make_serve_step`` steps
     (the recurrent states written in place), every step's logits within
     ``RZOO_TOL`` of the scale of ``Model.forward``'s over the same tokens
     with the same greedy tokens, rmsnorm's launches per decode step as
     predicted and flash's none (decode attention is plain code, as in
     JAX; paths ``serve_hymba`` / ``serve_xlstm``); (b) ``RZOO``'s
     training steps at 1 x 2048 through ``train`` (hymba whole, xlstm cut
     to 8 layers, one ``[mlstm x 7, slstm]`` group: its steps are bound
     by the sLSTM loop on the host; kernels vs plain versions, then hymba
     3 steps and xlstm 2 on one batch with a finite, falling loss; paths
     ``train_hymba`` / ``train_xlstm``), rmsnorm and flash launches per
     step as ``rzoo_launches`` predicts (hymba 8 a layer + 1 and 2 a
     layer; xlstm 2 a layer + 1 and none); (c) xlstm's sLSTM layers'
     share of its step (one layer's forward and backward timed,
     ``slstm_share``); each config's parameter GB, ms/step, tokens/s,
     decode tok/s and peak memory, and the phase's seconds beside
     ``P15_LIMIT_S``;
 16. the cross-attention zoo (``XZOO``), random weights from a seed, the
     cross layers' gates set to ``XZOO_GATES`` (JAX starts them at 0, the
     identity), each model freed before the next: (a) llama-3.2-vision-11b
     at its full 40 layers (a gated ``cross`` layer every 5th over 1601
     image embeddings; 40.4 GB) serving ``RZOO_ROWS`` rows through
     ``rzoo_serve`` over random context embeddings: ``Model.ctx_kv`` once,
     ``RZOO_PROMPT`` prompt tokens through ``decode_step`` and
     ``RZOO_GEN`` greedy four-argument ``make_serve_step`` steps, every
     step's logits within ``RZOO_TOL`` of the scale of ``Model.forward``'s
     over the same tokens and context, the same greedy tokens, rmsnorm 2 a
     layer + 1 a step and no flash (path ``serve_llama_vision``); (b) it
     trains at full width cut to ``XZOO_TRAIN_LAYERS`` (4 dense layers and
     the first cross layer) at 1 x 2048 over 1601 embeddings through
     ``train`` (kernels vs plain versions, then ``XZOO_STEPS`` steps on one
     batch, a finite, falling loss, rmsnorm and flash per step as
     ``xzoo_launches`` predicts; path ``train_llama_vision``); (c)
     whisper-tiny at its full size (4 ``xdec`` layers, a 4-layer encoder
     over 1500 frames) served as in (a), its encoder run once by
     ``ctx_kv`` (4 causal flash launches, path ``serve_whisper``), trained
     as in (b) at 8 x 448 over 8 x 1500 frames (path ``train_whisper``),
     and the train launcher for 2 steps (``XZOO_LAUNCHER``: no context,
     as JAX's; its cross layers attend the text itself, the non-causal
     flash launches counted, path ``launcher_whisper``); each config's
     parameter GB, ms/step, tokens/s, decode tok/s and peak memory, and
     the phase's seconds beside ``P16_LIMIT_S``;
 17. the examples (``repro_torch.examples``) and bert-moe: (a) the
     quickstart (reduced qwen3-moe-30b-a3b, Algorithm 1's pick under
     ``h100_model``, 60 steps under ``schedule="auto"``: finite losses,
     the last below the first); (b) serve_batched (qwen1.5-0.5b,
     qwen3-moe-30b-a3b, xlstm-350m and hymba-1.5b reduced, 4 rows x 24
     greedy tokens through the KV cache, every token in the vocabulary
     and equal to the plain versions' on the same weights);
     (c) train_100m at its full width (``config_100m``: ~100M parameters,
     ``P17_100M_STEPS`` steps of 8 x 256 tokens; the cross-entropy must
     fall, as the example asserts); (d) bert-moe (the paper's Table V
     BERT-Base-MoE, whole: 12 layers, 768 wide, E=8 top-2 every other
     layer) trained through ``train`` at ``P17_BERT`` (loss within 1e-4
     and gradient norm within 1e-3 of the plain versions' step, a finite,
     falling loss); (e)
     bert-moe served through the paged ``Engine`` (phase 4's 16 requests,
     ``P17_BERT_GEN`` tokens each, one request's logits through
     ``reference_check``); each path's launches exactly as ``P17_USES``
     (and serve_batched's as predicted there) predicts, paths
     ``example_quickstart``, ``example_serve_batched``,
     ``example_train_100m``, ``train_bert_moe`` and ``serve_bert_moe``;
     the phase's seconds beside ``P17_LIMIT_S``;
 18. print the kernels' JSON line (each kernel's launches on its main path
     and the phase-3 row at that path's shapes, under ``by_path`` every
     path's launches beside the phase-3 row at that path's shapes, and
     under ``multirank`` each phase-12 path's launches per rank, (i)'s
     as ``placement_2x2_*``, (j)'s as ``overlap_2x2_*``, (k)'s as
     ``kvcache_2x2_*``, phase 14 (c)'s as ``dryrun_4x2_*`` and
     ``comparison_4x2``, and under
     ``multirank_shape`` (k)'s paths beside
     the phase-3 row at one rank's shapes, ``MULTI_SHAPE_OF``), then
     ``{"ok": true, ...}`` as the last line.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
L2_BYTES = 50 * 2 ** 20            # H100 SXM
PEAK_FLOPS = {"torch.float32": 67e12, "torch.bfloat16": 989e12}
N_LAYERS = 4
L4 = "llama4-scout-17b-a16e"
#: sources whose every kernel instance must spill 0 bytes (ptxas -v)
NO_SPILL = ("flash_attention", "expert_ffn_grouped", "rmsnorm",
            "moe_dispatch", "expert_ffn")


#: ``main``'s start (``time.perf_counter``): each phase's first line
#: carries its seconds into the run
_T_START = None


def log(msg):
    if _T_START is not None and msg.startswith("phase "):
        msg = f"{msg} [{time.perf_counter() - _T_START:.1f} s into the run]"
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _replay_ms(calls, name):
    """(ms, how): the mean device time of the thunks ``calls``, captured
    once in a CUDA graph and the graph replayed between CUDA events (how =
    "graph"); where the capture fails, the summed device time of the
    kernels whose names hold ``name`` under ``torch.profiler`` over the
    same calls (how = "profiler")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    calls[0]()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for c in calls:
                c()
    except RuntimeError as e:
        torch.cuda.synchronize()
        log(f"    (CUDA graph capture failed: {e}; torch.profiler instead)")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for c in calls:
                c()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and name in e.name)
        return us / 1e3 / len(calls), "profiler"
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / len(calls), "graph"


def device_ms(fn, args, touched, name, iters=20):
    """(cold ms, warm ms, how): the mean device time of ``fn(*args)``, the
    wrapper's host work left out (``_replay_ms``).  Warm: ``iters`` calls
    on ``args``, whose data stays in the card's L2 between calls where it
    fits.  Cold: calls that cycle through copies of the tensors in
    ``args``, enough copies that three L2s' worth of the ``touched`` bytes
    (what one call reads and writes) come between two uses of one copy, so
    every call reads its inputs from DRAM."""
    import torch
    n = max(2, -(-3 * L2_BYTES // touched))
    copies = [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                             for a in args) for _ in range(n - 1)]
    warm, how = _replay_ms([lambda: fn(*args)] * iters, name)
    cold, how_cold = _replay_ms(
        [lambda c=c: fn(*c) for c in copies] * -(-iters // n), name)
    return cold, warm, how if how == how_cold else f"{how_cold} / {how}"


def bound(nbytes, flops, dtype):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def compare(name, got, want, tol):
    """Max |got - want|; fails unless it is <= tol * max(1, max|want|)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    if not err <= tol * scale:       # also catches NaN
        raise AssertionError(f"{name}: max_abs_err {err:.3e} > "
                             f"{tol:.1e} * {scale:.3g}")
    return err


# --- phase 3: kernels against their plain versions --------------------------

def check_rmsnorm(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.kernels.rmsnorm import rmsnorm
    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    # (label, rows, width, dtype, tol): f32 differs by rounding and rsqrt
    # ulps; bf16 output may differ by one bf16 ulp (2^-8 relative).  Then
    # phase 13's widths: decode at 5120 (llama4, mistral-nemo), 4096 (yi)
    # and 1024 (qwen1.5; xlstm's in phase 15), qwen1.5's training step
    # (xlstm's shape too), 13 (c)'s prefill of 4 x 2048 rows at 5120,
    # phase 15's hymba at 1600: its training step and its decode rows, and
    # phase 16's llama-3.2-vision training step at 4096 (its decode rows
    # are yi's ``decode-4096``), and phase 12 (l)'s xlstm step on a rank
    # of (2, 2), 1 x 512 at 1024, and phase 17's reduced archs: the
    # quickstart's step (8 x 64 tokens at 256) and serve_batched's 4
    # decode rows.
    f32 = torch.float32
    for label, R, D, dt, tol in (("decode", 8, 2048, f32, 1e-5),
                                 ("prefill128", 128, 2048, f32, 1e-5),
                                 ("prefill128-bf16", 128, 2048,
                                  torch.bfloat16, 1e-2),
                                 ("train-qwen3", 2048, 2048, f32, 1e-5),
                                 ("decode-5120", 8, 5120, f32, 1e-5),
                                 ("decode-4096", 8, 4096, f32, 1e-5),
                                 ("decode-1024", 8, 1024, f32, 1e-5),
                                 ("train-qwen1.5", 2048, 1024, f32, 1e-5),
                                 ("prefill-5120", 8192, 5120, f32, 1e-5),
                                 ("train-hymba", 2048, 1600, f32, 1e-5),
                                 ("decode-1600", 8, 1600, f32, 1e-5),
                                 ("train-4096", 2048, 4096, f32, 1e-5),
                                 ("train-512x1024", 512, 1024, f32, 1e-5),
                                 ("train-quickstart", 512, 256, f32, 1e-5),
                                 ("decode-256", 4, 256, f32, 1e-5)):
        x = torch.randn((R, D), generator=g, device=dev).to(dt)
        scale = 1.0 + 0.1 * torch.randn((D,), generator=g, device=dev)
        err = compare(f"rmsnorm[{label}]", rmsnorm(x, scale, eps=1e-6),
                      rmsnorm_ref(x, scale, 1e-6), tol)
        ms = time_ms(lambda: rmsnorm(x, scale, eps=1e-6))
        plain = time_ms(lambda: rmsnorm_ref(x, scale, 1e-6))
        lib = time_ms(lambda: F.rms_norm(x, (D,), weight=scale.to(dt),
                                         eps=1e-6))
        es = x.element_size()
        b_ms, b_by = bound(2 * R * D * es + D * 4, 4 * R * D, dt)
        log(f"  rmsnorm[{label}] ({R}, {D}) {dt}: max_abs_err {err:.3e} "
            f"(tol {tol:.0e}) kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"F.rms_norm {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return rows


def check_grouped(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.gating import topk_gate
    from repro_torch.core.moe import shard_pool_capacity
    from repro_torch.kernels.expert_ffn_grouped import (expert_ffn_grouped,
                                                        slot_rows)
    from repro_torch.kernels.ref import expert_ffn_grouped_ref
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    weights_of = {}

    def moe_of(arch):
        """``arch``'s MoE layer; phase 17's reduced qwen3 and the 100M
        example's gpt2-moe by name."""
        if arch == QS:
            return get_config(q3).reduced().moe
        if arch == "train-100m":
            from repro_torch.examples.train_100m import config_100m
            return config_100m().moe
        return get_config(arch).moe

    def arch_weights(arch):
        """(MoEConfig, f32 weights, gate weight) of ``arch``, made once."""
        if arch not in weights_of:
            mcfg = moe_of(arch)
            E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
            w = {"w1": randn(E, M, F, scale=M ** -0.5),
                 "w3": randn(E, M, F, scale=M ** -0.5),
                 "w2": randn(E, F, M, scale=F ** -0.5)}
            weights_of[arch] = (mcfg, w, randn(M, E, scale=M ** -0.5))
        return weights_of[arch]

    rows = []
    # (label, arch, tokens, infer, x dtype, bf16 weights, glu, act, wire,
    # tol): f32 sums of up to 8192 products in another order than cuBLAS's;
    # a bf16 output or bf16 wire rounding may differ by one bf16 ulp.  The
    # serving shapes first, then the two training steps' (phases 6 and 7:
    # all tokens of a step, the training capacity, each model's experts),
    # then phase 17's: the quickstart's reduced qwen3 step and
    # serve_batched's 4 decode rows, train_100m's step (8 x 256) and
    # bert-moe's (8 x 512) and its decode rows.
    q3, g2, QS = "qwen3-moe-30b-a3b", "gpt2-moe", "quickstart"
    f32, bf16 = torch.float32, torch.bfloat16
    cases = (("decode", q3, 8, True, f32, False, True, "silu", "f32", 1e-4),
             ("decode-llama4", L4, 8, True, f32, False, True, "silu", "f32",
              1e-4),
             ("prefill128", q3, 128, False, f32, False, True, "silu", "f32",
              1e-4),
             ("decode-bf16", q3, 8, True, bf16, True, True, "silu", "f32",
              1e-2),
             ("decode-wire-bf16", q3, 8, True, f32, False, True, "silu",
              "bf16", 1e-2),
             ("decode-gelu-2layer", q3, 8, True, f32, False, False, "gelu",
              "f32", 1e-4),
             ("train-qwen3", q3, 2048, False, f32, False, True, "silu",
              "f32", 1e-4),
             ("train-gpt2-moe", g2, 8192, False, f32, False, False, "silu",
              "f32", 1e-4),
             ("train-gpt2-moe-wire-bf16", g2, 8192, False, f32, False, False,
              "silu", "bf16", 1e-2),
             ("train-quickstart", QS, 512, False, f32, False, True, "silu",
              "f32", 1e-4),
             ("decode-quickstart", QS, 4, True, f32, False, True, "silu",
              "f32", 1e-4),
             ("train-100m", "train-100m", 2048, False, f32, False, False,
              "silu", "f32", 1e-4),
             ("train-bert-moe", "bert-moe", 4096, False, f32, False, False,
              "silu", "f32", 1e-4),
             ("decode-bert-moe", "bert-moe", 8, True, f32, False, False,
              "silu", "f32", 1e-4))
    for label, arch, S, infer, dt, wbf, glu, act, wire, tol in cases:
        if arch != L4:
            weights_of.pop(L4, None)       # llama4's 8 GB, once used
        mcfg, w, wg = arch_weights(arch)
        if label.startswith("train-") and (glu, act) != (mcfg.glu, mcfg.act):
            raise AssertionError(f"{label}: not {arch}'s expert FFN")
        E, M, F, k = mcfg.n_experts, mcfg.d_model, mcfg.d_ff, mcfg.top_k
        ws = {key: v.to(bf16) for key, v in w.items()} if wbf else w
        _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(),
                                     infer=infer)
        x = randn(S, M)
        r = topk_gate(x, wg, mcfg.gate_config(), cap)
        flat, weights = r.flat(cap, E), r.weights
        x = x.to(dt)
        w3 = ws["w3"] if glu else None

        def run_kernel():
            return expert_ffn_grouped(x, flat, weights, ws["w1"], w3,
                                      ws["w2"], cap=cap, act=act, wire=wire)

        def run_plain():
            return expert_ffn_grouped_ref(x, flat, weights, ws["w1"], w3,
                                          ws["w2"], cap=cap, act=act,
                                          wire=wire)

        err = compare(f"expert_ffn_grouped[{label}]", run_kernel(),
                      run_plain(), tol)
        ms = time_ms(run_kernel)
        plain = time_ms(run_plain, iters=5)
        _, counts = slot_rows(flat, S, E, cap)
        routed = int(counts.sum())
        hit = int((counts > 0).sum())
        n_mat = 3 if glu else 2
        wes, es = ws["w1"].element_size(), x.element_size()
        nbytes = (2 * S * M * es + 2 * S * k * 4
                  + hit * n_mat * M * F * wes)
        flops = 2 * n_mat * routed * M * F
        b_ms, b_by = bound(nbytes, flops, dt)
        log(f"  expert_ffn_grouped[{label}] S={S} k={k} E={E} M={M} F={F} "
            f"cap={cap} {dt} act={act} glu={glu} wire={wire}: routed rows "
            f"{routed}, hit experts {hit}; max_abs_err {err:.3e} (tol "
            f"{tol:.0e}) kernel {ms:.4f} ms  plain {plain:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def _flash_plain_rows(q, k, v, *, causal=True, window=None, scale=None,
                      rows=2048):
    """``flash_attention_plain``'s causal rows one block of ``rows``
    queries at a time (the same f32 scores, ``-inf`` mask and softmax per
    row; queries [i, i + rows) over keys [0, i + rows)), so that a long
    sequence's (L, L) scores never stand whole on the card."""
    import torch
    if not causal or window is not None or q.shape[1] != k.shape[1]:
        raise ValueError("_flash_plain_rows: causal self-attention only")
    H, K, L = q.shape[2], k.shape[2], q.shape[1]
    k = torch.repeat_interleave(k, H // K, dim=2).float()
    v = torch.repeat_interleave(v, H // K, dim=2).float()
    out = torch.empty_like(q)
    for i in range(0, L, rows):
        j = min(L, i + rows)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, i:j].float(), k[:, :j])
        qp = torch.arange(i, j, device=q.device)[:, None]
        kp = torch.arange(j, device=q.device)[None, :]
        s = torch.where((kp <= qp)[None, None], s * scale, -torch.inf)
        out[:, i:j] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(
            s, dim=-1), v[:, :j]).to(q.dtype)
    return out


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    # (label, B, L, H, K, hd, dtype, causal, window, tol): the two training
    # shapes, a window narrower than L, non-causal, bf16, qwen1.5's training
    # step (MHA 16 x 64), llama4's heads (40 / 8 x 128; no path trains
    # llama4 at full width on one card), phase 13 (c)'s KV-cache
    # prefill of mistral-nemo (4 x 2048, 32 / 8 x 128) and phase 12 (k)'s
    # on one rank of (2, 2) (16 / 4 heads a rank: B=1 at 1 x 16384, B=2
    # at 1 x 2048), phase 15's hymba training step (25 / 5 x 64: a GQA
    # group of 5, a 1024-token window; the bound counts in-window pairs,
    # SDPA takes the same mask), and phase 16's: whisper-tiny's encoder
    # over 8 x 1500 frames (causal, as in JAX; a ragged last query tile of
    # 92 rows) and its decoder's 8 x 448 tokens, the train launcher's
    # non-causal cross layers over those tokens themselves (``noncausal``),
    # and llama-3.2-vision's training step (1 x 2048, 32 / 8 x 128), and
    # phase 12 (m)'s on one rank of (2, 2): whisper's encoder at 3 heads a
    # rank, llama-3.2-vision's step at 16 / 4, and phase 17's: the
    # quickstart's reduced qwen3 (8 x 64), train_100m's 8 x 256 and
    # bert-moe's training step (8 x 512, 12 x 64; causal, as JAX keys
    # it).  f32:
    # sums of up to L terms in another order, and the online softmax's
    # per-tile rescaling; bf16 output: one bf16 ulp.
    cases = (("qwen3", 1, 2048, 32, 4, 128, torch.float32, True, None, 5e-5),
             ("gpt2-moe", 8, 1024, 12, 12, 64, torch.float32, True, None,
              5e-5),
             ("window256", 2, 1024, 8, 2, 128, torch.float32, True, 256,
              5e-5),
             ("non-causal", 2, 512, 12, 12, 64, torch.float32, False, None,
              5e-5),
             ("qwen3-bf16", 1, 2048, 32, 4, 128, torch.bfloat16, True, None,
              2e-2),
             ("qwen1.5", 1, 2048, 16, 16, 64, torch.float32, True, None,
              5e-5),
             ("llama4", 1, 2048, 40, 8, 128, torch.float32, True, None,
              5e-5),
             ("mistral-nemo-prefill", 4, 2048, 32, 8, 128, torch.float32,
              True, None, 5e-5),
             ("mistral-nemo-16k-rank", 1, 16384, 16, 4, 128, torch.float32,
              True, None, 5e-5),
             ("mistral-nemo-2k-rank", 1, 2048, 16, 4, 128, torch.float32,
              True, None, 5e-5),
             ("hymba", 1, 2048, 25, 5, 64, torch.float32, True, 1024,
              5e-5),
             ("whisper-enc", 8, 1500, 6, 6, 64, torch.float32, True, None,
              5e-5),
             ("whisper-dec", 8, 448, 6, 6, 64, torch.float32, True, None,
              5e-5),
             ("noncausal", 8, 448, 6, 6, 64, torch.float32, False, None,
              5e-5),
             ("llama-vision", 1, 2048, 32, 8, 128, torch.float32, True, None,
              5e-5),
             ("whisper-enc-mp2", 8, 1500, 3, 3, 64, torch.float32, True,
              None, 5e-5),
             ("llama-vision-mp2", 1, 2048, 16, 4, 128, torch.float32, True,
              None, 5e-5),
             ("quickstart", 8, 64, 4, 4, 64, torch.float32, True, None,
              5e-5),
             ("train-100m", 8, 256, 8, 8, 64, torch.float32, True, None,
              5e-5),
             ("bert-moe", 8, 512, 12, 12, 64, torch.float32, True, None,
              5e-5))
    for label, B, L, H, K, hd, dt, causal, window, tol in cases:
        q = torch.randn((B, L, H, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, L, K, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, L, K, hd), generator=g, device=dev).to(dt)
        kw = dict(causal=causal, window=window, scale=hd ** -0.5)
        plain_fn = flash_attention_plain if L <= 4096 else _flash_plain_rows
        err = compare(f"flash_attention[{label}]",
                      flash_attention(q, k, v, **kw),
                      plain_fn(q, k, v, **kw), tol)
        ms = time_ms(lambda: flash_attention(q, k, v, **kw))
        plain = time_ms(lambda: plain_fn(q, k, v, **kw), iters=5)
        # the yardstick, on (B, H, L, hd) copies made outside the timing
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pos = torch.arange(L, device=dev)
        d = pos[:, None] - pos[None, :]
        mask = None
        if window is not None:
            mask = (d >= 0) & (d < window) if causal else d < window
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            scale=hd ** -0.5, enable_gqa=True))
        # the (query, key) pairs this data needs: causal rows see q + 1
        # keys, windowed rows at most ``window``
        seen = torch.full((L,), L, device=dev)
        if causal:
            seen = pos + 1
        if window is not None:
            seen = torch.clamp(seen, max=window)
        pairs = int(seen.sum()) * B * H
        es = q.element_size()
        b_ms, b_by = bound(B * (2 * L * H + 2 * L * K) * hd * es,
                           4 * pairs * hd, dt)
        log(f"  flash_attention[{label}] B={B} L={L} H={H} K={K} hd={hd} "
            f"{dt} causal={causal} window={window}: max_abs_err {err:.3e} "
            f"(tol {tol:.0e}) kernel {ms:.4f} ms  plain {plain:.4f} ms  "
            f"sdpa {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return rows


def _gate_case(g, dev, arch, S, infer):
    """(MoEConfig, x, gate result, cap) for ``S`` random tokens of
    ``arch`` at the capacity its path uses."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.gating import topk_gate
    from repro_torch.core.moe import shard_pool_capacity
    mcfg = get_config(arch).moe
    E, M = mcfg.n_experts, mcfg.d_model
    _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(), infer=infer)
    x = torch.randn((S, M), generator=g, device=dev)
    wg = torch.randn((M, E), generator=g, device=dev).mul_(M ** -0.5)
    return mcfg, x, topk_gate(x, wg, mcfg.gate_config(), cap), cap


def check_dispatch_combine(dev):
    """moe_dispatch and moe_combine at the paths' shapes: serving decode
    (s1d; qwen3's and llama4's), the qwen3 and gpt2-moe training steps,
    bf16, and a dispatch whose every odd token shares its even neighbour's
    first slot.  Each row's kernel time is logged host-inclusive
    (``time_ms``, the wrapper's calls back to back: at decode the host's
    time) and device-only (``device_ms``), cold (every call's inputs read
    from DRAM: the figure the bound, a DRAM rate, is held against) and
    L2-warm (one input reread, as the back-to-back calls read it)."""
    import torch
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.ref import moe_combine_ref, moe_dispatch_ref
    g = torch.Generator(device=dev).manual_seed(4)
    q3, g2 = "qwen3-moe-30b-a3b", "gpt2-moe"
    f32, bf16 = torch.float32, torch.bfloat16
    disp, comb = [], []
    # (label, arch, tokens, infer, dtype, duplicates).  Tolerances: dispatch
    # 0 (each slot receives at most one value: 0 + v == v), duplicates 0
    # too (the kernel and the plain version's sorted index_put_ both sum
    # in token order);
    # combine 1e-6 in f32 (k terms in choice order against cuBLAS's), bf16
    # one ulp (2e-2).
    for label, arch, S, infer, dt, dup in (
            ("decode", q3, 8, True, f32, False),
            ("decode-llama4", L4, 8, True, f32, False),
            ("train-qwen3", q3, 2048, False, f32, False),
            ("train-gpt2-moe", g2, 8192, False, f32, False),
            ("train-gpt2-moe-bf16", g2, 8192, False, bf16, False),
            ("duplicates", g2, 8192, False, f32, True)):
        mcfg, x, r, cap = _gate_case(g, dev, arch, S, infer)
        E, M, k = mcfg.n_experts, mcfg.d_model, mcfg.top_k
        n = E * cap
        flat, w = r.flat(cap, E), r.weights
        if dup:
            flat = flat.clone()
            flat[1::2, 0] = flat[0::2, 0]
        x = x.to(dt)
        es = x.element_size()
        tol = 0.0
        err = compare(f"moe_dispatch[{label}]", moe_dispatch(x, flat, n),
                      moe_dispatch_ref(x, flat, n), tol)
        ms = time_ms(lambda: moe_dispatch(x, flat, n))
        nbytes = S * M * es + S * k * 4 + n * M * es
        cold, warm, how = device_ms(moe_dispatch, (x, flat, n), nbytes,
                                    "dispatch_kernel")
        plain = time_ms(lambda: moe_dispatch_ref(x, flat, n))
        src = x[:, None].expand(S, k, M).reshape(S * k, M)
        idx = flat.reshape(-1).long()
        # the same function in one call: zeros made once, outside the
        # timing, and never written (index_add returns a new tensor)
        zeros = torch.zeros((n + 1, M), dtype=dt, device=dev)
        lib = time_ms(lambda: torch.index_add(zeros, 0, idx, src))
        b_ms, b_by = bound(nbytes, S * k * M, dt)
        log(f"  moe_dispatch[{label}] S={S} k={k} M={M} n_slots={n} {dt}: "
            f"max_abs_err {err:.3e} (tol {tol:.0e}) kernel {ms:.4f} ms "
            f"(host-inclusive), device {cold:.4f} ms cold, {warm:.4f} ms "
            f"L2-warm ({how})  plain "
            f"{plain:.4f} ms  torch.index_add {lib:.4f} ms  bound "
            f"{b_ms:.4f} ms ({b_by})")
        disp.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        if dup:
            continue
        buf = torch.randn((n, M), generator=g, device=dev).to(dt)
        tol = 1e-6 if dt == f32 else 2e-2
        err = compare(f"moe_combine[{label}]", moe_combine(buf, flat, w),
                      moe_combine_ref(buf, flat, w), tol)
        ms = time_ms(lambda: moe_combine(buf, flat, w))
        kept = int((flat < n).sum())
        nbytes = kept * M * es + S * k * 8 + S * M * es
        cold, warm, how = device_ms(moe_combine, (buf, flat, w), nbytes,
                                    "combine_kernel")
        plain = time_ms(lambda: moe_combine_ref(buf, flat, w))
        # the same function in one call: bags of k rows, the indices
        # clamped to n - 1 and the dropped choices' weights 0, as the
        # plain version does (its inputs made once, outside the timing)
        bag = flat.long().clamp(max=n - 1)
        bag_w = torch.where(flat < n, w, torch.zeros_like(w)).to(dt)
        err_lib = compare(
            f"F.embedding_bag[{label}]",
            torch.nn.functional.embedding_bag(
                bag, buf, per_sample_weights=bag_w, mode="sum"),
            moe_combine_ref(buf, flat, w), tol)
        lib = time_ms(lambda: torch.nn.functional.embedding_bag(
            bag, buf, per_sample_weights=bag_w, mode="sum"))
        b_ms, b_by = bound(nbytes, 2 * kept * M, dt)
        log(f"  moe_combine[{label}] S={S} k={k} M={M} kept {kept} {dt}: "
            f"max_abs_err {err:.3e} (tol {tol:.0e}) kernel {ms:.4f} ms "
            f"(host-inclusive), device {cold:.4f} ms cold, {warm:.4f} ms "
            f"L2-warm ({how})  plain "
            f"{plain:.4f} ms  F.embedding_bag {lib:.4f} ms "
            f"(max_abs_err {err_lib:.3e})  bound {b_ms:.4f} ms ({b_by})")
        comb.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib))
    return disp, comb


def check_expert_ffn(dev):
    """expert_ffn at the paths' shapes: s1d serving decode (qwen3 and
    llama4, SwiGLU), qwen3's training capacity buffer (the measured
    calibration's candidates, phase 11) and gpt2-moe's, whole and as one
    of two chunks (two-layer silu).  Tolerance 1e-4: f32 sums of up to
    8192 products in another order than cuBLAS's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import shard_pool_capacity
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.ref import expert_ffn_ref
    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for label, arch, S, infer, n_chunks in (
            ("decode", "qwen3-moe-30b-a3b", 8, True, 1),
            ("decode-llama4", L4, 8, True, 1),
            ("train-qwen3", "qwen3-moe-30b-a3b", 2048, False, 1),
            ("train-gpt2-moe", "gpt2-moe", 8192, False, 1),
            ("train-gpt2-moe-chunk", "gpt2-moe", 8192, False, 2)):
        mcfg = get_config(arch).moe
        E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
        _, cap = shard_pool_capacity(S, 1, 1, mcfg.gate_config(),
                                     infer=infer)
        T = cap // n_chunks
        x = torch.randn((E, T, M), generator=g, device=dev)
        w1 = torch.randn((E, M, F), generator=g, device=dev).mul_(M ** -0.5)
        w3 = torch.randn((E, M, F), generator=g, device=dev).mul_(
            M ** -0.5) if mcfg.glu else None
        w2 = torch.randn((E, F, M), generator=g, device=dev).mul_(F ** -0.5)
        act = mcfg.act
        err = compare(f"expert_ffn[{label}]",
                      expert_ffn(x, w1, w3, w2, act=act),
                      expert_ffn_ref(x, w1, w3, w2, act=act), 1e-4)
        ms = time_ms(lambda: expert_ffn(x, w1, w3, w2, act=act))
        plain = time_ms(lambda: expert_ffn_ref(x, w1, w3, w2, act=act),
                        iters=5)
        n_mat = 3 if mcfg.glu else 2
        b_ms, b_by = bound(2 * E * T * M * 4 + n_mat * E * M * F * 4,
                           2 * n_mat * E * T * M * F, torch.float32)
        log(f"  expert_ffn[{label}] E={E} T={T} M={M} F={F} glu="
            f"{mcfg.glu} act={act}: max_abs_err {err:.3e} (tol 1e-4) "
            f"kernel {ms:.4f} ms  plain {plain:.4f} ms  (no single PyTorch "
            f"call)  bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del x, w1, w3, w2
    return rows


def check_ragged(dev):
    """expert_ffn_ragged at the s1g + fp8 training steps (one group, counts
    min(load, cap) of a random gate): qwen3's (E 128, cap 160, SwiGLU), with
    counts that cut 16-row tiles and on a bf16 pool, and gpt2-moe's (E 8,
    8192 tokens, two-layer silu; phase 9).  Tolerance 1e-4 (f32, as
    expert_ffn; bf16 output one ulp, 2e-2); rows at or past a count must be
    exactly 0."""
    import torch
    g = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for arch, S, cases in (
            ("qwen3-moe-30b-a3b", 2048, (
                ("train-qwen3-fp8", "gate", torch.float32, 1e-4),
                ("partial", "partial", torch.float32, 1e-4),
                ("train-qwen3-fp8-bf16", "gate", torch.bfloat16, 2e-2))),
            ("gpt2-moe", 8192, (
                ("train-gpt2-moe-fp8", "gate", torch.float32, 1e-4),))):
        rows += _ragged_rows(g, dev, arch, S, cases)
    return rows


def _ragged_rows(g, dev, arch, S, cases):
    import torch
    from repro_torch.kernels.expert_ffn_grouped import expert_ffn_ragged
    from repro_torch.kernels.ref import expert_ffn_ragged_ref
    mcfg, _, r, cap = _gate_case(g, dev, arch, S, False)
    E, M, F = mcfg.n_experts, mcfg.d_model, mcfg.d_ff
    w1, w3 = (torch.randn((E, M, F), generator=g, device=dev).mul_(M ** -0.5)
              for _ in range(2))
    if not mcfg.glu:
        w3 = None
    w2 = torch.randn((E, F, M), generator=g, device=dev).mul_(F ** -0.5)
    n_mat = 3 if mcfg.glu else 2
    act = mcfg.act
    counts_of = {
        "gate": torch.clamp(r.aux["load"], max=float(cap)).to(
            torch.int32)[:, None].contiguous(),
        "partial": torch.randint(0, 41, (E, 1), generator=g, device=dev,
                                 dtype=torch.int32)}
    rows = []
    for label, kind, dt, tol in cases:
        counts = counts_of[kind]
        xb = torch.randn((E, 1, cap, M), generator=g, device=dev).to(dt)
        got = expert_ffn_ragged(xb, counts, w1, w3, w2, act=act)
        err = compare(f"expert_ffn_ragged[{label}]", got,
                      expert_ffn_ragged_ref(xb, counts, w1, w3, w2, act=act),
                      tol)
        tail = torch.arange(cap, device=dev)[None, None, :] \
            >= counts[:, :, None]
        if not bool((got[tail] == 0).all()):
            raise AssertionError(f"expert_ffn_ragged[{label}]: a row past "
                                 f"its count is not exactly 0")
        ms = time_ms(lambda: expert_ffn_ragged(xb, counts, w1, w3, w2,
                                               act=act))
        plain = time_ms(lambda: expert_ffn_ragged_ref(xb, counts, w1, w3,
                                                      w2, act=act), iters=5)
        routed = int(counts.sum())
        hit = int((counts > 0).sum())
        es = xb.element_size()
        b_ms, b_by = bound(routed * M * es + E * cap * M * es + E * 4
                           + hit * n_mat * M * F * 4,
                           2 * n_mat * routed * M * F, torch.float32)
        log(f"  expert_ffn_ragged[{label}] E={E} G=1 c={cap} M={M} F={F} "
            f"glu={mcfg.glu} act={act} "
            f"{dt}: routed rows {routed}, hit experts {hit}; max_abs_err "
            f"{err:.3e} (tol {tol:.0e}), tail rows exactly 0; kernel "
            f"{ms:.4f} ms  plain {plain:.4f} ms  (no single PyTorch call)  "
            f"bound {b_ms:.4f} ms ({b_by})")
        rows.append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows


def check_codec(dev):
    """The fp8 wire codec on the card (``cat`` and ``view`` of fp8
    tensors): bytes equal to the CPU's for the same input, and the round
    trip's time at qwen3's s1g + fp8 pool (128 x 160 rows of 2048)."""
    import torch
    from repro_torch.core.collectives import (CommConfig, wire_decode,
                                              wire_encode, wire_roundtrip)
    comm = CommConfig(wire_dtype="fp8_e4m3")
    x = torch.randn((1024, 2048), device=dev)
    x[3] *= 1e3
    enc = wire_encode(x, comm)
    ne = enc.view(torch.uint8).cpu() != wire_encode(x.cpu(), comm).view(
        torch.uint8)
    if ne.any():
        raise AssertionError(
            f"fp8 wire_encode: {int(ne[:, :-4].sum())} payload and "
            f"{int(ne[:, -4:].sum())} scale-tail bytes on the card differ "
            f"from the CPU's")
    if not torch.equal(wire_decode(enc, comm, torch.float32).cpu(),
                       wire_decode(enc.cpu(), comm, torch.float32)):
        raise AssertionError("fp8 wire_decode differs from the CPU's")
    pool = torch.randn((128 * 160, 2048), device=dev)
    ms = time_ms(lambda: wire_roundtrip(pool, comm))
    log(f"  fp8 wire codec: bytes on the card equal the CPU's; round trip "
        f"of a (20480, 2048) f32 pool {ms:.4f} ms")
    return ms


def check_schedules(dev):
    """Phase 6: one gpt2-moe MoE layer at full width under the one-rank
    schedules, s1g included: bitwise equal to each other, within 1e-4 of
    the plain versions; each schedule's forward timed (no grad)."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import apply_moe, init_moe_params
    cfg = get_config("gpt2-moe").moe
    params = init_moe_params(torch.Generator(device=dev).manual_seed(7), cfg)
    x = torch.randn((8, 1024, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev)
    outs, times = {}, {}
    runs = (("baseline", 1), ("s1", 1), ("s2", 1), ("s2h", 1), ("s1d", 1),
            ("s1_pipe", 2), ("s2_pipe", 2), ("s1g", 1))
    with torch.no_grad():
        for sched, n in runs:
            c = replace(cfg, schedule=sched, pipeline_chunks=n)
            outs[sched], aux = apply_moe(x, params, cfg=c)
            times[sched] = time_ms(lambda: apply_moe(x, params, cfg=c),
                                   iters=5)
        with plain_ops():
            plain, _ = apply_moe(x, params, cfg=replace(cfg, schedule="s1"))
    want = outs["baseline"]
    bad = [sch for sch, _ in runs if not torch.equal(outs[sch], want)]
    if bad:
        raise AssertionError(f"phase 6: {bad} differ bitwise from baseline")
    err_p = compare("phase 6: kernels vs plain versions", want, plain, 1e-4)
    log(f"  gpt2-moe MoE layer, 8 x 1024 tokens, drop fraction "
        f"{float(aux['drop_frac']):.4f}: {', '.join(s for s, _ in runs)}"
        f" bitwise equal; plain versions max_abs_err {err_p:.3e} (tol "
        f"1e-4); forward ms "
        + " ".join(f"{s} {t:.3f}" for s, t in times.items()))
    return times


# --- phases 4 and 5: serving ------------------------------------------------

def make_requests(vocab, n=16, prefix_len=32, seed=0):
    """``n`` prompts of 4..128 tokens; every third starts with one shared
    ``prefix_len``-token prefix."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prefix = list(rng.randint(0, vocab, prefix_len))
    reqs = []
    for i in range(n):
        if i % 3 == 0:
            tail = rng.randint(1, 129 - prefix_len)
            prompt = prefix + list(rng.randint(0, vocab, tail))
        else:
            prompt = list(rng.randint(0, vocab, rng.randint(4, 129)))
        reqs.append(prompt)
    return reqs


def serve(model, params, prompts, *, gen, order=None, deadline=0.0,
          **engine_kw):
    """Serve ``prompts`` (submitted in ``order``, each with ``deadline``)
    and return (completions by rid, engine, wall seconds)."""
    import torch
    from repro_torch.serve import Engine
    eng = Engine(model, max_batch=8, max_len=256, block_size=16, **engine_kw)
    for i in (order if order is not None else range(len(prompts))):
        eng.submit(prompts[i], gen, rid=i, deadline=deadline)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(params)
    wall = time.perf_counter() - t0
    return {c.rid: c for c in done}, eng, wall


@contextlib.contextmanager
def plain_ops():
    """Swap the plain PyTorch versions in behind ``get_op`` (the reference
    forward of phase 4, the plain layer of phase 6 and the reference steps
    of phases 7 and 8 only)."""
    from repro_torch.kernels import registry
    saved = dict(registry._OPS)
    registry._OPS.update(registry.PLAIN)
    try:
        yield
    finally:
        registry._OPS.clear()
        registry._OPS.update(saved)


def reference_check(model, params, prompt, schedule=None):
    """Last-position logits of one one-shot prefill under ``schedule``,
    kernels vs plain versions, on fresh arenas.  f32 throughout; tolerance
    1e-3 of the logits' scale (4 layers of f32 sums in different
    orders)."""
    import numpy as np
    import torch
    from repro_torch.serve.engine import prefill_bucket
    L = len(prompt)
    lb = prefill_bucket([L], 256)
    toks = np.zeros((1, lb), np.int32)
    toks[0, :L] = prompt
    nb = -(-lb // 16)
    batch = {"tokens": torch.from_numpy(toks).to(model.device),
             "starts": torch.zeros(1, dtype=torch.int32, device=model.device),
             "lens": torch.tensor([L], dtype=torch.int32, device=model.device),
             "tables": torch.arange(1, nb + 1, dtype=torch.int32,
                                    device=model.device)[None]}
    out = []
    for ctx in (contextlib.nullcontext(), plain_ops()):
        with ctx, torch.no_grad():
            logits, _ = model.paged_step(params, model.init_cache(nb + 1, 16),
                                         batch, schedule=schedule,
                                         infer=False)
        out.append(logits)
    err = compare("paged_step logits (kernels vs plain)", out[0], out[1],
                  1e-3)
    same = bool(torch.equal(out[0].argmax(-1), out[1].argmax(-1)))
    if not same:
        raise AssertionError("greedy token differs between kernels and "
                             "plain versions")
    return err


def serve_report(label, done, eng, wall, n_requests, gen):
    from repro_torch.serve import latency_stats
    if len(done) != n_requests:
        raise AssertionError(f"{label}: {len(done)} of {n_requests} done")
    for c in done.values():
        if len(c.tokens) != gen or not all(
                0 <= t < eng.model.cfg.vocab_size for t in c.tokens):
            raise AssertionError(f"{label}: request {c.rid} returned "
                                 f"{c.tokens}")
    st = latency_stats(done.values())
    s = eng.stats
    log(f"  {label}: {st['n_tokens']} tokens in {wall:.3f} s: "
        f"{st['tok_per_s']:.1f} tok/s  p50 {st['p50_ms']:.1f} ms  "
        f"p99 {st['p99_ms']:.1f} ms  ttft p50 {st['ttft_p50_ms']:.1f} ms  "
        f"p99 {st['ttft_p99_ms']:.1f} ms; {s['prefill_calls']} prefill "
        f"calls, {s['decode_calls']} decode rounds, prefix hits "
        f"{s['prefix_hits']} ({s['prefix_tokens']} tokens)")
    return st


# --- phases 6 and 7: training ----------------------------------------------

def kernel_wrappers():
    from repro_torch.kernels.expert_ffn import expert_ffn
    from repro_torch.kernels.expert_ffn_grouped import (expert_ffn_grouped,
                                                        expert_ffn_ragged)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_dispatch import moe_combine, moe_dispatch
    from repro_torch.kernels.rmsnorm import rmsnorm
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "expert_ffn_grouped": expert_ffn_grouped,
            "moe_dispatch": moe_dispatch, "moe_combine": moe_combine,
            "expert_ffn": expert_ffn, "expert_ffn_ragged": expert_ffn_ragged}


def reset_counts():
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def read_counts(wrappers):
    return {name: fn.launches for name, fn in wrappers.items()}


def reference_step(model, params, batch, schedule=None, grad_rtol=1e-3):
    """Loss and gradient norm of one step (no update), with the kernels and
    with the plain versions, from the same parameters.  Loss within 1e-4
    relative, gradient norm within ``grad_rtol`` (1e-3): f32 throughout,
    but the kernels' forwards sum in other orders than the plain versions'
    and the routing of a near tie may flip."""
    from repro_torch.optim.adamw import global_norm, leaves
    from repro_torch.train.loop import grads_of
    flat = leaves(params)
    for t in flat:
        t.requires_grad_(True)
    out = []
    for ctx in (contextlib.nullcontext(), plain_ops()):
        with ctx:
            loss, _ = model.loss(params, batch, schedule=schedule)
            grads = grads_of(loss, flat)
            out.append((loss.item(), global_norm(grads).item()))
            del grads, loss
    (lk, gk), (lp, gp) = out
    if not (abs(lk - lp) <= 1e-4 * abs(lp) and abs(gk - gp) <= grad_rtol * gp):
        raise AssertionError(f"loss {lk} / grad norm {gk} with the kernels, "
                             f"{lp} / {gp} with the plain versions")
    return out


class _OneBatch:
    """``data`` (a ``SyntheticLM``) with batch 0 at every step."""

    def __init__(self, data):
        self.data = data

    def tensors(self, step, device):
        return self.data.tensors(0, device)


class _WithCtx:
    """``data`` with one ``ctx_embeds`` tensor beside every batch (the
    modality frontend's output, which the port takes precomputed)."""

    def __init__(self, data, ctx):
        self.data, self.ctx = data, ctx

    def tensors(self, step, device):
        return {**self.data.tensors(step, device), "ctx_embeds": self.ctx}


#: the gates of every cross layer the smoke runs: JAX starts them at 0,
#: where a cross layer is the identity and its ``xattn`` and ``ffn`` get
#: zero gradients (the CPU tests set the same values on both packages)
XZOO_GATES = {"gate_attn": 0.5, "gate_ffn": -0.3}


def set_gates(model, params):
    """``XZOO_GATES`` into every ``cross`` run of ``params``, in place."""
    import torch
    with torch.no_grad():
        for r, (kind, _) in enumerate(model.runs):
            for name, value in XZOO_GATES.items():
                if name in params[f"run{r}"]:
                    params[f"run{r}"][name].fill_(value)


def train(label, cfg, dev, *, batch, seq, steps, lr, uses, schedule=None,
          per_step=None, grad_rtol=1e-3, with_ms=False, repeat=True,
          one_batch=False, ctx=None):
    """Phases 7 and 8: the first step taken twice and once guarded from one
    state, all bitwise (``repeat``), ``reference_step``, then ``steps``
    AdamW steps through ``Trainer`` under ``schedule`` with the kernels'
    counts set to 0 just before (``one_batch``: every step on batch 0, so
    that the falling loss reads the optimizer, not the batches' spread).
    ``ctx``: the ``ctx_embeds`` of every batch (a cross-attention model,
    its gates set to ``XZOO_GATES``).
    Every kernel in ``uses`` must launch; ``per_step`` maps kernels to
    their predicted launches per step, which must hold exactly.  Returns
    the launches of the run by kernel (``with_ms``: and the ms a step
    after the first)."""
    import math

    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.determinism import first_steps
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import (disable_fp8_monitor, enable_fp8_monitor,
                                     reset_fp8_counter)
    from repro_torch.train import Trainer, make_guarded_train_step
    model = Model(cfg, device=dev)
    tr = Trainer(model, AdamWConfig(lr=lr, warmup_steps=2,
                                    total_steps=steps), schedule=schedule)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch))
    if ctx is not None:
        data = _WithCtx(data, ctx)
    # the first step twice from one state: bitwise, with no deterministic
    # flag and no CUBLAS_WORKSPACE_CONFIG (the backward sums in order); and
    # the guarded step on the clean path: bitwise the plain one
    guarded = make_guarded_train_step(model, tr.opt_cfg, schedule)

    def guarded_clean(params, opt_state, batch):
        enable_fp8_monitor()
        try:
            return guarded(params, opt_state, batch, 1.0, 0.0)
        finally:
            disable_fp8_monitor()
            reset_fp8_counter()

    t0 = time.perf_counter()
    bad, bad_guarded = first_steps(tr, data.tensors(0, dev), [
        tr.train_step, tr.train_step, guarded_clean]) if repeat else ([], [])
    t_repeat = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"{label}: the first step taken twice from "
                             f"the same state differs in tensors {bad} of "
                             f"the parameters, AdamW moments, step and "
                             f"loss")
    if bad_guarded:
        raise AssertionError(f"{label}: the guarded first step (lr_scale "
                             f"1.0, grad_fault 0.0) differs from the plain "
                             f"one in tensors {bad_guarded} of the "
                             f"parameters, AdamW moments, step and loss")
    params, opt_state = tr.setup(torch.Generator(device=dev).manual_seed(0))
    if model.has_cross:
        set_gates(model, params)
    n_leaves = len(_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    moe = "dense" if cfg.moe is None else (
        f"schedule {schedule or cfg.moe.schedule}, "
        f"{cfg.moe.pipeline_chunks} chunk(s), wire {cfg.moe.comm.wire_dtype}")
    log(f"  {label}: {cfg.name}, {cfg.n_layers} layers, {n_bytes / 1e9:.2f} "
        f"GB of parameters, batch {batch} x {seq} tokens, remat "
        f"{cfg.remat}, {moe}")
    t0 = time.perf_counter()
    (lk, gk), (lp, gp) = reference_step(model, params, data.tensors(0, dev),
                                        schedule, grad_rtol)
    log(f"  {label}: one step from the same parameters: loss {lk:.6f} "
        f"(kernels) vs {lp:.6f} (plain), grad norm {gk:.6f} vs {gp:.6f} "
        f"({time.perf_counter() - t0:.1f} s)"
        + ("; the first step taken twice, and once guarded (lr_scale 1.0, "
           f"grad_fault 0.0, fp8 monitor on): all {3 * n_leaves} parameter "
           "and moment tensors, the step counter and the loss torch.equal "
           f"({t_repeat:.1f} s)" if repeat else ""))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    params, opt_state, hist = tr.run(
        params, opt_state, _OneBatch(data) if one_batch else data, steps,
        log_every=1)
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    step_ms = (hist[-1]["wall_s"] - hist[0]["wall_s"]) / (steps - 1) * 1e3
    log(f"  {label}: {steps} steps, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; {step_ms:.1f} ms/step and "
        f"{batch * seq / step_ms * 1e3:.1f} tokens/s after the first step; "
        f"peak device memory {peak:.2f} GB; launches per step "
        f"{ {k: v / steps for k, v in launches.items()} }")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: non-finite loss in {losses}")
    if not sum(losses[-3:]) / len(losses[-3:]) < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    if any(launches[name] <= 0 for name in uses):
        raise AssertionError(f"{label}: a kernel of the path was never "
                             f"launched: {launches}")
    for name, n in (per_step or {}).items():
        if launches[name] != n * steps:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches in {steps} steps, predicted "
                                 f"{n} per step")
    del params, opt_state, tr, model
    torch.cuda.empty_cache()
    return (launches, step_ms) if with_ms else launches


# --- phase 9: guarded training -----------------------------------------------

#: phase 9 (a): the plan, and the guard events it must give as (kind, step,
#: streak, restored step): skips at 3 and 4 (max_skips 2), the fp8
#: fallback at step 3 (the NaN cotangents saturate the backward's fp8
#: encodes), a rollback at 4 past the bit-flipped step-2 snapshot to step
#: 0, a skip at 5; tests/test_torch_runtime.py pins the same list against
#: the JAX package on the CPU
PHASE9_FAULTS = "nan_grad@step=3-5;ckpt_bitflip@save=2"
PHASE9_EVENTS = [("skip", 3, 1, None), ("fp8_fallback", None, None, None),
                 ("skip", 4, 2, None), ("rollback", 4, None, 0),
                 ("skip", 5, 1, None)]
PHASE9_COUNTERS = {"steps": 10, "skipped": 3, "rollbacks": 1,
                   "loss_spikes": 0, "fp8_fallbacks": 1,
                   "rollback_unavailable": 0}


def p9_config(g2, tokens=(8, 1024)):
    """Phase 9's run (and phase 12 (e)'s): ``g2`` (gpt2-moe) cut to 4
    layers on the fp8 wire, ``tokens`` = (batch, seq) ``SyntheticLM``
    tokens a step, AdamW at lr 1e-3 over 10 steps."""
    from dataclasses import replace

    from repro_torch.core.collectives import CommConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    cfg = replace(g2, n_layers=4, moe=replace(
        g2.moe, comm=CommConfig(wire_dtype="fp8_e4m3")))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tokens[1], global_batch=tokens[0]))
    return cfg, data, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)


def stream_guard_events(evs):
    """The guard events of a read stream, in ``sink_guard_events``'s
    form."""
    got = []
    for e in evs:
        if e["event"] in ("guard_skip", "guard_rollback"):
            got.append((e["event"], e["step"],
                        e["streak"] if e["event"] == "guard_skip"
                        else e["restored_step"])
                       + ((e["lr_scale"],)
                          if e["event"] == "guard_skip" else ()))
        elif e["event"] == "fp8_fallback":
            got.append((e["event"], e["sat_rate"], e["wire"]))
    return got


def _state_tensors(params, opt_state):
    return (_leaves(params) + _leaves(opt_state["mu"])
            + _leaves(opt_state["nu"]) + [opt_state["step"]])


def guarded_training(dev, g2, fp8_per_layer, grouped_per_layer):
    """Phase 9 (see the module docstring).  ``fp8_per_layer`` maps the
    ragged path's kernels to their launches per MoE layer and step (phase
    7's qwen3 s1g + fp8 run), ``grouped_per_layer`` is
    ``expert_ffn_grouped``'s (phase 8's gpt2-moe run).  Returns the
    launches of the (a) and (c) runs by kernel, as two paths, and (a)'s
    losses (phase 12 (e)'s reference)."""
    import math
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core import autosched, collectives
    from repro_torch.models import Model
    from repro_torch.obs.sink import read_events
    from repro_torch.runtime import (FaultPlan, GuardConfig,
                                     disable_fp8_monitor, reset_fp8_counter)
    from repro_torch.train import Trainer

    cfg, data, opt = p9_config(g2)
    n_moe = sum(n for kind, n in cfg.runs() if "moe" in kind)
    model = Model(cfg, device=dev)

    def trainer(**kw):
        tr = Trainer(model, opt, schedule="s1g", **kw)
        return (tr, *tr.setup(torch.Generator(device=dev).manual_seed(0)))

    def reset_globals():
        autosched.set_wire_ceiling(None)
        collectives.set_fp8_sat_injection(0.0)
        disable_fp8_monitor()
        reset_fp8_counter()

    def state_bytes(params, opt_state):
        return sum(t.numel() * t.element_size()
                   for t in _state_tensors(params, opt_state))

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the faulted run
        tr, params, opt_state = trainer(
            ckpt_path=os.path.join(tmp, "run.npz"),
            guards=GuardConfig(max_skips=2),
            faults=FaultPlan.parse(PHASE9_FAULTS), ckpt_retain=2)
        p_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        s_bytes = state_bytes(params, opt_state)
        log(f"  {cfg.name}, {cfg.n_layers} layers ({n_moe} MoE), s1g, wire "
            f"fp8_e4m3, batch 8 x 1024: {p_bytes / 1e9:.3f} GB of "
            f"parameters, {s_bytes / 1e9:.3f} GB per snapshot with both "
            f"moments; faults {PHASE9_FAULTS}")
        # phase 10 (f): the same run with a telemetry sink installed
        obs.configure(os.path.join(tmp, "metrics"), meta={"phase": "9 (a)"})
        wrappers = reset_counts()
        try:
            params, opt_state, hist = tr.run(params, opt_state, data, 10,
                                             log_every=1, ckpt_every=2)
            torch.cuda.synchronize()
            metrics = obs.get_sink().paths
        finally:
            obs.close()
        launches["train_gpt2_moe_guarded_s1g_fp8"] = read_counts(wrappers)
        gs, mgr = tr.guard_state, tr.rollback_mgr
        events = [(e["kind"], e.get("step"), e.get("streak"),
                   e.get("restored_step")) for e in gs.events]
        if events != PHASE9_EVENTS or gs.counters != PHASE9_COUNTERS:
            raise AssertionError(f"phase 9 (a): events {gs.events}, "
                                 f"counters {gs.counters}")
        snaps = [(e["kind"], e["step"]) for e in mgr.events]
        restored = [e for e in mgr.events if e["kind"] == "rollback"]
        if (snaps != [("snapshot", 0), ("snapshot", 2), ("rollback", 4),
                      ("snapshot", 6), ("snapshot", 8)]
                or not restored[0]["path"].endswith("run.step00000000.npz")
                or mgr.store.steps() != [6, 8]):
            raise AssertionError(f"phase 9 (a): the store's history "
                                 f"{mgr.events}, retained "
                                 f"{mgr.store.steps()}")
        losses = p9_losses = [h["loss"] for h in hist]
        if not math.isfinite(losses[-1]) or [
                i for i, x in enumerate(losses) if not math.isfinite(x)] \
                != [3, 4, 5]:
            raise AssertionError(f"phase 9 (a): losses {losses}")
        log(f"  (a) 10 steps: losses {' '.join(f'{x:.4f}' for x in losses)}"
            f"; events {gs.events}; {gs.summary()}; the rollback at step 4 "
            f"skipped the corrupt step-2 snapshot and restored step 0; "
            f"retained {mgr.store.steps()}; launches "
            f"{ {k: v for k, v in read_counts(wrappers).items() if v} }")
        evs = read_events(metrics)
        got = stream_guard_events(evs)
        sat3 = [e for e in evs if e["event"] == "fp8_sat"
                and e["step"] == 3]
        # moe_call counts the step's MoE calls: each block's recompute in
        # the backward (remat) is a call of its own
        if got != sink_guard_events(gs.events) or not sat3 or not all(
                (0 <= e["moe_call"] < 2 * n_moe and e["schedule"] == "s1g"
                 and e["wire"] == "fp8_e4m3") for e in sat3):
            raise AssertionError(f"phase 10 (f): sink events {got}, "
                                 f"expected {sink_guard_events(gs.events)}; "
                                 f"step-3 fp8_sat events {sat3}")
        log(f"  phase 10 (f) the same run with a sink: {len(evs)} events, "
            f"the guard events exactly GuardState.events' ({got}); "
            f"{len(sat3)} fp8_sat events at step 3, e.g. "
            f"{ {k: sat3[0][k] for k in ('step', 'moe_call', 'schedule', 'wire', 'sat', 'total')} }"
            f"; fp8_sat events by step "
            f"{ {s: sum(e['step'] == s for e in evs if e['event'] == 'fp8_sat') for s in range(10)} }")
        reset_globals()

        # (b) save -> restore in place -> one more step, bitwise
        path = os.path.join(tmp, "b.npz")
        live = {"params": params, "opt_state": opt_state}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, live, 10)
        t_save = time.perf_counter() - t0
        batch = data.tensors(10, dev)
        ptrs = [t.data_ptr() for t in _state_tensors(params, opt_state)]
        params, opt_state, m = tr.train_step(params, opt_state, batch)
        want = [t.detach().to("cpu") for t in
                _state_tensors(params, opt_state)] + [m["loss"].cpu()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, step = load_checkpoint(path, into=live)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        params, opt_state, m = tr.train_step(params, opt_state, batch)
        got = _state_tensors(params, opt_state) + [m["loss"]]
        bad = [i for i, (a, b) in enumerate(zip(want, got))
               if not torch.equal(a, b.detach().to("cpu"))]
        if step != 10 or bad or ptrs != [
                t.data_ptr() for t in _state_tensors(params, opt_state)]:
            raise AssertionError(f"phase 9 (b): restored step {step}; "
                                 f"tensors {bad} differ after the round "
                                 f"trip, or a tensor moved")
        gb = s_bytes / 1e9
        log(f"  (b) save {t_save:.3f} s ({gb / t_save:.2f} GB/s), restore "
            f"in place {t_restore:.3f} s ({gb / t_restore:.2f} GB/s; "
            f"two reads of the file: crc check, then copy_) of "
            f"{gb:.3f} GB ({os.path.getsize(path) / 1e9:.3f} GB on disk); "
            f"one more step after the round trip: all {len(want)} "
            f"tensors and the loss torch.equal, every tensor in place")
        del tr, params, opt_state, live, want, got, m
        torch.cuda.empty_cache()

    # (c) injected fp8 saturation: the ragged path in step 0, then the
    # fused grouped kernel on the bf16 wire
    tr, params, opt_state = trainer(guards=GuardConfig(),
                                    faults=FaultPlan.parse(
                                        "fp8_sat@factor=64"))
    wrappers = reset_counts()
    per_step, inner = [], tr.guarded_step

    def counted(*args):
        before = read_counts(wrappers)
        out = inner(*args)
        after = read_counts(wrappers)
        per_step.append({k: after[k] - before[k] for k in after})
        return out

    tr.guarded_step = counted
    params, opt_state, hist = tr.run(params, opt_state, data, 4,
                                     log_every=1)
    torch.cuda.synchronize()
    launches["train_gpt2_moe_fp8_fallback"] = read_counts(wrappers)
    gs = tr.guard_state
    ragged = {k: n * n_moe for k, n in fp8_per_layer.items()}
    first = {**ragged, "expert_ffn_grouped": 0}
    later = {**{k: 0 for k in ragged},
             "expert_ffn_grouped": grouped_per_layer * n_moe}
    seen = [{k: c[k] for k in first} for c in per_step]
    losses = [h["loss"] for h in hist]
    if ([e["kind"] for e in gs.events] != ["fp8_fallback"]
            or autosched.wire_ceiling() != "bf16"
            or seen != [first] + [later] * 3
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"phase 9 (c): events {gs.events}, ceiling "
                             f"{autosched.wire_ceiling()}, launches per "
                             f"step {seen} (predicted {first} in step 0, "
                             f"{later} after), losses {losses}")
    log(f"  (c) fp8_sat@factor=64: {gs.events[0]}; launches per step "
        f"{seen} (predicted from phases 7 and 8); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    reset_globals()
    del tr, params, opt_state
    torch.cuda.empty_cache()

    # (d) the guarded clean loop against the plain one, and (phase 10 (f))
    # the guarded loop with a telemetry sink, in turns (the host is shared:
    # step times move between runs, so three of each, each side first as
    # often)
    times, steps = [], 8
    with tempfile.TemporaryDirectory() as tmp:
        for i, side in enumerate(("plain", "guarded", "sink", "sink",
                                  "guarded", "plain", "plain", "sink",
                                  "guarded")):
            tr, params, opt_state = trainer(
                guards=None if side == "plain" else GuardConfig())
            if side == "sink":
                obs.configure(os.path.join(tmp, str(i)))
            try:
                hist = tr.run(params, opt_state, data, steps,
                              log_every=1)[2]
                torch.cuda.synchronize()
            finally:
                obs.close()
            ms = (hist[-1]["wall_s"] - hist[0]["wall_s"]) / (steps - 1) * 1e3
            times.append((side, ms, hist[-1]["loss"]))
            reset_globals()
            del tr, params, opt_state, hist
            torch.cuda.empty_cache()
    if len({loss for _, _, loss in times}) != 1:
        raise AssertionError(f"phase 9 (d): the plain, guarded and sink "
                             f"clean runs end on different losses: {times}")
    med = {side: sorted(ms for label, ms, _ in times if label == side)[1]
           for side in ("plain", "guarded", "sink")}
    log(f"  (d) ms/step after the first step ({steps} steps, each step's "
        f"loss read), in turns: "
        + ", ".join(f"{label} {ms:.2f}" for label, ms, _ in times)
        + f"; medians plain {med['plain']:.2f}, guarded "
        f"{med['guarded']:.2f} ({med['guarded'] / med['plain'] - 1:+.2%}), "
        f"guarded with a sink {med['sink']:.2f} "
        f"({med['sink'] / med['guarded'] - 1:+.2%} over guarded); the same "
        f"last loss bits")
    return launches, p9_losses


# --- phase 10: serving under faults and deadlines, and the telemetry -------

#: phase 10 (a): rid 1 force-expired after 4 ticks, rid 2 stalled into the
#: watchdog (6 rounds), every free arena block held hostage for 8 ticks
PHASE10_FAULTS = ("req_timeout@rid=1,ticks=4;req_delay@rid=2,rounds=999;"
                  "alloc_starve@tick=1,hold=9999,rounds=8")
LIFECYCLE = ["req_queued", "req_admitted", "req_prefilled", "req_finished"]


def _balanced(eng, label):
    """The allocator's ledger balances and no page is live."""
    eng.pool.alloc_blocks.check()
    if eng.pool.n_live:
        raise AssertionError(f"{label}: {eng.pool.n_live} pages still live")


def serve_robustness(model, params, prompts, gen, want):
    """Phase 10 (a)-(e) (see the module docstring).  ``want`` is phase 5's
    forward run (prefix cache off, one request per prefill call), the
    fault-free reference.  Returns (a)'s launches by kernel."""
    import tempfile

    import torch
    from repro_torch import obs
    from repro_torch.obs.registry import quantile
    from repro_torch.obs.sink import read_events
    from repro_torch.runtime import FaultPlan
    from repro_torch.serve import Engine, latency_stats
    n = len(prompts)

    # (a) the chaos plan: two requests cut, the other 14 bitwise
    wrappers = reset_counts()
    done, eng, wall = serve(model, params, prompts, gen=gen,
                            prefix_cache=False, watchdog_rounds=6,
                            faults=FaultPlan.parse(PHASE10_FAULTS))
    torch.cuda.synchronize()
    launches = read_counts(wrappers)
    cut = {rid: (c.status, c.reason, len(c.tokens))
           for rid, c in done.items() if c.status != "ok"}
    bad = [i for i in range(n) if i not in (1, 2)
           and (done[i].status, done[i].tokens) != ("ok", want[i].tokens)]
    if (sorted(done) != list(range(n)) or sorted(cut) != [1, 2]
            or cut[1][0] != "expired" or "tick" not in cut[1][1]
            or cut[2][0] != "evicted" or "watchdog" not in cut[2][1]
            or bad or eng.stats["expired"] != 1
            or eng.stats["evicted"] != 1):
        raise AssertionError(f"phase 10 (a): cut {cut}, requests {bad} "
                             f"differ from the fault-free run, stats "
                             f"{eng.stats}")
    for rid in (1, 2):
        if done[rid].tokens != want[rid].tokens[:len(done[rid].tokens)]:
            raise AssertionError(f"phase 10 (a): request {rid}'s partial "
                                 f"stream is not a prefix of its own")
    _balanced(eng, "phase 10 (a)")
    if min(launches[k] for k in ("rmsnorm", "expert_ffn_grouped")) <= 0:
        raise AssertionError(f"phase 10 (a): a kernel of the path was never "
                             f"launched: {launches}")
    log(f"  (a) {PHASE10_FAULTS}, watchdog 6 rounds: {cut}; the other "
        f"{n - 2} requests' tokens equal phase 5's; {eng.stats['expired']} "
        f"expired, {eng.stats['evicted']} evicted, {eng.stats['decode_calls']}"
        f" decode rounds in {wall:.3f} s; pages balance; launches "
        f"{ {k: v for k, v in launches.items() if v} }")

    # (b) a deadline at its extreme expires every request mid-flight
    eng = Engine(model, max_batch=8, max_len=256, block_size=16,
                 prefix_cache=False)
    for i in range(3):
        eng.submit(prompts[i], gen, rid=i, deadline=1e-6)
    got = [(c.status, c.reason) for c in eng.run(params)]
    if len(got) != 3 or any(st != "expired" or not r.startswith("deadline")
                            for st, r in got):
        raise AssertionError(f"phase 10 (b): {got}")
    _balanced(eng, "phase 10 (b)")
    log(f"  (b) 3 requests with a 1e-6 s deadline: {got[0][0]} "
        f"({got[0][1]}) x 3; pages balance")

    # (c) the sheds: a request no arena of 2 blocks can hold, and one that
    # waits past a ~0 queue SLO behind a pinned-full pool
    eng = Engine(model, max_batch=2, max_len=64, n_blocks=2, block_size=16)
    eng.submit(list(range(1, 7)), 40)
    eng.submit(list(range(1, 7)), 4)
    c0, c1 = eng.run(params)
    _balanced(eng, "phase 10 (c)")
    slo = Engine(model, max_batch=1, max_len=256, block_size=16,
                 prefix_cache=False, queue_slo=1e-6)
    slo.submit(prompts[0], 8)
    slo.submit(prompts[1], 8)
    q0, q1 = slo.run(params)
    _balanced(slo, "phase 10 (c)")
    if ((c0.status, c1.status, len(c1.tokens)) != ("shed", "ok", 4)
            or not c0.reason.startswith("blocks")
            or eng.stats["shed_blocks"] != 1
            or (q0.status, q1.status) != ("ok", "shed")
            or not q1.reason.startswith("queue")
            or slo.stats["shed_queue"] != 1):
        raise AssertionError(f"phase 10 (c): {c0}, {c1}, {q0}, {q1}")
    log(f"  (c) 2-block arena: shed ({c0.reason}), the small request beside "
        f"it ok with {len(c1.tokens)} tokens; one row and a 1e-6 s queue "
        f"SLO: shed ({q1.reason}); pages balance")

    # (d) the knobs' cost: watchdog, a 60 s deadline on every request, a
    # 60 s queue SLO and a JSONL sink, against the plain run, in turns
    runs, events, n_bytes = [], None, 0
    with tempfile.TemporaryDirectory() as tmp:
        for i, knobs in enumerate((False, True, True, False, False, True)):
            kw = dict(prefix_cache=False)
            if knobs:
                obs.configure(os.path.join(tmp, str(i)), meta={
                    "kind": "serve", "phase": "10 (d)"})
                kw.update(watchdog_rounds=6, queue_slo=60.0, deadline=60.0)
            try:
                done, eng, wall = serve(model, params, prompts, gen=gen,
                                        **kw)
                paths = obs.get_sink().paths if knobs else None
            finally:
                obs.close()
            st = latency_stats(done.values())
            runs.append(("knobs" if knobs else "plain", st["tok_per_s"],
                         st["p50_ms"], st["p99_ms"]))
            bad = [r for r in range(n) if (done[r].status, done[r].tokens)
                   != ("ok", want[r].tokens)]
            if bad:
                raise AssertionError(f"phase 10 (d): requests {bad} differ "
                                     f"from the fault-free run")
            if knobs:
                events = read_events(paths)
                n_bytes = sum(os.path.getsize(p) for p in paths)
                stats = dict(eng.stats)
    med = {side: [sorted(r[j] for r in runs if r[0] == side)[1]
                  for j in (1, 2, 3)] for side in ("plain", "knobs")}
    log("  (d) in turns: " + ", ".join(
        f"{side} {tps:.1f} tok/s p50 {p50:.1f} p99 {p99:.1f} ms"
        for side, tps, p50, p99 in runs)
        + f"; medians plain {med['plain'][0]:.1f} tok/s p50 "
        f"{med['plain'][1]:.1f} p99 {med['plain'][2]:.1f} ms, knobs "
        f"{med['knobs'][0]:.1f} tok/s p50 {med['knobs'][1]:.1f} p99 "
        f"{med['knobs'][2]:.1f} ms ({med['knobs'][0] / med['plain'][0] - 1:+.2%}"
        f" tok/s); all six runs give phase 5's tokens")

    # (e) the last knobs run's event stream
    per_rid = {}
    for e in events:
        if e["event"].startswith("req_"):
            per_rid.setdefault(e["rid"], []).append(e["event"])
    rounds = sum(e["event"] == "decode_round" for e in events)
    lats = sorted(e["latency_s"] for e in events
                  if e["event"] == "req_finished")
    roll = [e for e in events if e["event"] == "serve_rollup"]
    if (sorted(per_rid) != list(range(n))
            or any(v != LIFECYCLE for v in per_rid.values())
            or rounds != stats["decode_calls"] or len(roll) != 1
            or roll[0]["latency_s.p50"] != quantile(lats, 50)):
        raise AssertionError(f"phase 10 (e): lifecycles {per_rid}, "
                             f"{rounds} decode_round events for "
                             f"{stats['decode_calls']} rounds, rollup {roll}")
    log(f"  (e) {len(events)} events, {n_bytes} bytes: every request "
        f"{' -> '.join(LIFECYCLE)}; {rounds} decode_round events = decode "
        f"rounds; serve_rollup latency_s.p50 {roll[0]['latency_s.p50']:.4f} "
        f"s = quantile of the {len(lats)} finished latencies")
    # the sink's own host cost: an event into the buffer, and one write of
    # a full buffer (64 events, the sink's default) to the file
    from repro_torch.obs.sink import JsonlSink
    with tempfile.TemporaryDirectory() as tmp:
        sink = JsonlSink(tmp, buffer_events=1 << 30)
        t_emit, t_flush = [], []
        for _ in range(20):
            t0 = time.perf_counter()
            for i in range(64):
                sink.emit("decode_round", tick=i, rows=8, active=8,
                          block_occupancy=0.25)
            t1 = time.perf_counter()
            sink.flush()
            t_emit.append((t1 - t0) / 64)
            t_flush.append(time.perf_counter() - t1)
        sink.close()
    log(f"  (e) the sink under {tempfile.gettempdir()}: "
        f"{sorted(t_emit)[10] * 1e6:.1f} us an event (median of 20 x 64), "
        f"{sorted(t_flush)[10] * 1e3:.3f} ms a write of 64 (median; max "
        f"{max(t_flush) * 1e3:.3f})")
    return launches


def sink_guard_events(gs_events):
    """The guard events a sink receives for ``GuardState.events``: a skip
    that fills the streak is recorded by the rollback it triggers."""
    out = []
    for i, e in enumerate(gs_events):
        nxt = gs_events[i + 1] if i + 1 < len(gs_events) else {}
        if e["kind"] == "skip" and not (nxt.get("kind") == "rollback"
                                        and nxt["step"] == e["step"]):
            out.append(("guard_skip", e["step"], e["streak"],
                        e["lr_scale"]))
        elif e["kind"] == "rollback":
            out.append(("guard_rollback", e["step"], e["restored_step"]))
        elif e["kind"] == "fp8_fallback":
            out.append(("fp8_fallback", e["sat_rate"], e["wire"]))
    return out


def stage_traces(dev, forward_ms):
    """Phase 10 (g): stage traces of phase 6's gpt2-moe MoE layer (8 x 1024
    tokens) under s1 and s1g through ``trace_schedule``'s harness; the
    stage names are the plan's validated order, the Chrome JSON loads, and
    the full plan after the timer is bitwise ``apply_moe`` before and after
    it.  Returns each trace's launches as a path."""
    import tempfile
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import executor
    from repro_torch.core import plan as planlib
    from repro_torch.core.moe import apply_moe
    from repro_torch.obs.audit import _LayerHarness
    from repro_torch.obs.trace import save_chrome_trace
    cfg = get_config("gpt2-moe").moe
    h = _LayerHarness(cfg, 8 * 1024, seed=7, device=dev)
    x = h.x.view(8, 1024, cfg.d_model)
    launches = {}
    for sched in ("s1", "s1g"):
        c = replace(cfg, schedule=sched)
        plan = planlib.build_plan(sched, h.info())
        with torch.no_grad():
            before, _ = apply_moe(x, h.params, cfg=c)
            wrappers = reset_counts()
            st = h.trace(sched)
            torch.cuda.synchronize()
            launches[f"trace_gpt2_moe_{sched}"] = read_counts(wrappers)
            full, _ = executor.execute(plan, *h.args, h.info())
            after, _ = apply_moe(x, h.params, cfg=c)
        names = [s.name for s in planlib.validate(plan)]
        with tempfile.TemporaryDirectory() as tmp:
            doc = json.load(open(save_chrome_trace(
                st, os.path.join(tmp, "trace.json"))))
        slices = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
        if ([s.name for s in st.stages] != names or slices != names
                or not torch.equal(before.view(-1, cfg.d_model), full)
                or not torch.equal(before, after)):
            raise AssertionError(f"phase 10 (g) {sched}: stages "
                                 f"{[s.name for s in st.stages]}, plan "
                                 f"{names}, Chrome slices {slices}, or the "
                                 f"outputs moved")
        log(f"  (g) {sched}: " + ", ".join(
            f"{s.name} ({s.kind}) {s.measured_s * 1e3:.3f}"
            for s in st.stages)
            + f" ms; prefix 0 {st.overhead_s * 1e3:.3f} ms, full plan "
            f"{st.total_s * 1e3:.3f} ms (phase 6's forward "
            f"{forward_ms[sched]:.3f} ms); Chrome JSON loads; the output "
            f"torch.equal before and after the timer; launches "
            f"{ {k: v for k, v in launches[f'trace_gpt2_moe_{sched}'].items() if v} }")
    return launches


# --- phase 11: the cost model and the autoscheduler -------------------------

def serve_measured(model, params, prompts, gen, want):
    """Phase 11 (e): phase 4's model and prompts served one-shot under
    ``autosched="measured"`` (every prefill bucket and the decode pool
    calibrated on the card once): every request's tokens phase 4's
    one-shot run's (``want``).  Returns the run's launches by kernel."""
    from dataclasses import replace

    from repro_torch.core import autosched
    from repro_torch.models import Model
    cfg = model.cfg
    measured = Model(replace(cfg, moe=replace(cfg.moe, autosched="measured")),
                     device=model.device)
    autosched.clear_cache()
    wrappers = reset_counts()
    done, eng, wall = serve(measured, params, prompts, gen=gen)
    launches = read_counts(wrappers)
    bad = [i for i in range(len(prompts)) if done[i].tokens != want[i].tokens]
    if bad:
        raise AssertionError(f"phase 11 (e): requests {bad} differ from "
                             f"phase 4's one-shot run")
    summary = autosched.cache_summary()
    if "decode]" not in summary or "autosched[measured]" not in summary:
        raise AssertionError(f"phase 11 (e): decisions {summary!r}")
    log(f"  (e) qwen3 served one-shot under autosched=measured: "
        f"{len(prompts)}/{len(prompts)} requests phase 4's tokens in "
        f"{wall:.3f} s (calibrations included); launches "
        f"{ {k: v for k, v in launches.items() if v} }; decisions:")
    for line in summary.splitlines():
        log(f"      {line}")
    autosched.clear_cache()
    return launches


def _measured_decision(cfg, dev, B, L, infer):
    """Resolve ``cfg`` (measured mode) at a (B, L) pool as ``apply_moe``
    does and return the decision it cached and its cache key."""
    from dataclasses import replace

    from repro_torch.core import autosched
    from repro_torch.core.moe import resolve_schedule
    before = set(autosched.cache_info())
    resolve_schedule(replace(cfg, autosched="measured"), B=B, L=L,
                     infer=infer, device=dev)
    (key, d), = [(k, v) for k, v in autosched.cache_info().items()
                 if k not in before]
    return key, d


def autoscheduling(dev, forward_ms, serve_cfg, prompts, gen):
    """Phase 11 (a)-(d), (f), (g) (see the module docstring).  Returns the
    measured paths' launches by kernel and the decision of (d)."""
    import math
    import tempfile
    from dataclasses import replace

    import torch
    from repro_torch import obs
    from repro_torch import runtime as trt
    from repro_torch.configs import get_config
    from repro_torch.core import autosched
    from repro_torch.core import moe as tmoe
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.moe import resolve_schedule
    from repro_torch.core.perfmodel import h100_model
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.fit_perfmodel import (measure_card,
                                                  model_from_fits, report)
    from repro_torch.models import Model
    from repro_torch.obs.audit import run_schedule_audit
    from repro_torch.obs.sink import read_events
    from repro_torch.optim import AdamWConfig
    from repro_torch.serve.engine import prefill_bucket
    from repro_torch.serve import suggest_max_batch
    from repro_torch.train import Trainer
    paths = {}

    # (a) the card's fits
    t0 = time.perf_counter()
    fits = measure_card(dev)
    fitted, sheet = model_from_fits(fits), h100_model(1, 1, 1)
    for line in report(fits, fitted):
        log(f"  (a) {line}")
    if not (fits["flops"]["r2"] > 0.8 and fits["alpha"]["r2"] > 0.8):
        raise AssertionError(f"phase 11 (a): R^2 {fits['flops']['r2']}, "
                             f"{fits['alpha']['r2']} (want > 0.8)")
    log(f"  (a) fitted: flops_per_s {fitted.flops_per_s:.6e}, collective "
        f"alpha {fitted.a2a_ep_esp.alpha:.6e} s; data sheet: "
        f"{sheet.flops_per_s:.6e}, {sheet.a2a_ep_esp.alpha:.6e} s "
        f"({time.perf_counter() - t0:.1f} s)")

    # (b) analytic decisions at every main-path shape, under both models
    q3, g2 = serve_cfg.moe, get_config("gpt2-moe").moe
    buckets = sorted({prefill_bucket([len(p)], 256) for p in prompts}
                     | {prefill_bucket([32], 256)})
    shapes = ([("qwen3 decode", q3, 8, 1, True)]
              + [(f"qwen3 prefill {b}", q3, 1, b, False) for b in buckets]
              + [("qwen3 train", q3, 1, 2048, False),
                 ("gpt2-moe train", g2, 8, 1024, False)])
    for name, pm in (("data sheet", sheet), ("fitted", fitted)):
        got = {label: resolve_schedule(c, B=B, L=L, infer=inf,
                                       perf_model=pm)
               for label, c, B, L, inf in shapes}
        bad = {k: v for k, v in got.items() if v != ("s1g", 1, "f32")}
        if bad:
            raise AssertionError(f"phase 11 (b) {name}: {bad}")
        log(f"  (b) analytic, {name} model: s1g x1 f32 at "
            + ", ".join(got))

    # (c) measured decisions
    for path, label, c, B, L, inf in (
            ("autosched_measure_gpt2_moe", "gpt2-moe 8 x 1024", g2, 8,
             1024, False),
            ("autosched_measure_qwen3_train", "qwen3 1 x 2048", q3, 1,
             2048, False),
            ("autosched_measure_qwen3_decode", "qwen3 decode 8 rows", q3, 8,
             1, True)):
        autosched.clear_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        wrappers = reset_counts()
        t0 = time.perf_counter()
        key, d = _measured_decision(c, dev, B, L, inf)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        paths[path] = read_counts(wrappers)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not all(math.isfinite(t) for _, t in d.times):
            raise AssertionError(f"phase 11 (c) {label}: {d.times}")
        wrappers = reset_counts()
        measure = autosched.measure_candidates(
            c, tokens=B * L, d_model=c.d_model, device=dev)
        again = autosched.decide(key[0], perf_model=key[3],
                                 mode="measured", chunk_candidates=key[2],
                                 wire_candidates=key[4], measure=measure)
        resolve_schedule(replace(c, autosched="measured"), B=B, L=L,
                         infer=inf, device=dev)
        if again is not d or any(read_counts(wrappers).values()):
            raise AssertionError(f"phase 11 (c) {label}: the second "
                                 f"decide calibrated again")
        fwd = (" (phase 6's forward ms: " + " ".join(
            f"{k} {v:.3f}" for k, v in forward_ms.items()) + ")"
            if c is g2 else "")
        log(f"  (c) measured {label}: {len(d.times)} candidates in "
            f"{secs:.2f} s, peak device memory {peak:.2f} GB; pick "
            f"{d.schedule} x{d.n_chunks} {d.wire_dtype}; median ms "
            + " ".join(f"{'/'.join(map(str, cand))} {t * 1e3:.3f}"
                       for cand, t in d.times) + fwd)
    autosched.clear_cache()

    # (d) gpt2-moe trained under measured mode and an auto wire, with a
    # sink; then from the same seed forced to its pick
    auto = replace(g2, autosched="measured",
                   comm=CommConfig(wire_dtype="auto"))
    full = replace(get_config("gpt2-moe"), moe=auto)
    data = SyntheticLM(DataConfig(vocab_size=full.vocab_size, seq_len=1024,
                                  global_batch=8))
    runs = {}

    def run(cfg, label):
        model = Model(cfg, device=dev)
        tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=3))
        params, opt_state = tr.setup(
            torch.Generator(device=dev).manual_seed(0))
        calls, step = [], tr.train_step

        def counted(*a):
            out = step(*a)
            calls.append(dict(tmoe._CALLS))
            return out
        tr.train_step = counted
        trt.reset_fp8_counter()
        with tempfile.TemporaryDirectory() as tmp:
            obs.configure(tmp, meta={"phase": f"11 (d) {label}"})
            try:
                wrappers = reset_counts()
                params, opt_state, hist = tr.run(params, opt_state, data, 3,
                                                 log_every=1)
                torch.cuda.synchronize()
                launches = read_counts(wrappers)
                obs.flush()
                events = read_events(obs.get_sink().paths)
            finally:
                obs.close()
        runs[label] = dict(state=_state_tensors(params, opt_state),
                           calls=calls, sat=trt.fp8_sat_counts(),
                           events=events, launches=launches,
                           losses=[h["loss"] for h in hist])
        del model, tr, params, opt_state
        torch.cuda.empty_cache()

    autosched.clear_cache()
    t0 = time.perf_counter()
    run(full, "measured")
    (key, d), = autosched.cache_info().items()
    autosched.clear_cache()
    forced = replace(full, moe=replace(
        g2, schedule=d.schedule, pipeline_chunks=d.n_chunks,
        comm=CommConfig(wire_dtype=d.wire_dtype)))
    run(forced, "forced")
    m, f = runs["measured"], runs["forced"]
    same = [i for i, (a, b) in enumerate(zip(m["state"], f["state"]))
            if not torch.equal(a, b)]
    decisions = [e for e in m["events"] if e["event"] == "autosched_decision"]
    if (same or len(m["state"]) != len(f["state"])
            or m["calls"] != f["calls"] or m["sat"] != f["sat"]
            or len(decisions) != 1 or key[1] != "measured"
            or any(e["event"] == "autosched_decision" for e in f["events"])):
        raise AssertionError(
            f"phase 11 (d): tensors {same} differ, ordinals {m['calls']} vs "
            f"{f['calls']}, fp8 counts {m['sat']} vs {f['sat']}, decision "
            f"events {decisions}")
    paths["train_gpt2_moe_measured"] = m["launches"]
    log(f"  (d) gpt2-moe {full.n_layers} layers, 8 x 1024, 3 steps under "
        f"autosched=measured, wire auto: pick {d.schedule} x{d.n_chunks} "
        f"{d.wire_dtype} (from {len(d.times)} candidates); losses "
        + " ".join(f"{x:.4f}" for x in m["losses"])
        + f"; all {len(m['state'])} parameter and moment tensors torch.equal"
        f" to the run forced to the pick; moe_call state per step "
        f"{m['calls']} and fp8 counts {m['sat']} the forced run's; one "
        f"autosched_decision event ({decisions[0]['tokens']} tokens); "
        f"{time.perf_counter() - t0:.1f} s for both runs")

    # (f) the schedule audit at gpt2-moe's layer under the fitted model
    reports = run_schedule_audit(g2, 8 * 1024, perf_model=fitted,
                                 device=dev)
    for rep in reports:
        log(f"  (f) audit {rep['schedule']}: predicted/measured ms "
            + ", ".join(f"{s['name']} {s['predicted_s'] * 1e3:.3f}/"
                        f"{s['measured_s'] * 1e3:.3f}" for s in rep["stages"])
            + f"; total {rep['total_predicted_s'] * 1e3:.3f}/"
            f"{rep['total_measured_s'] * 1e3:.3f}; worst {rep['worst']}; "
            f"time_scale {rep['calibration']['time_scale']:.4f}; priced at "
            f"zero: " + ", ".join(
                f"{s['name']} {s['measured_s'] * 1e3:.3f} ms"
                for s in rep["stages"] if s["predicted_s"] == 0.0))

    # (g) the decode batch from the cost model, phase 4's serving budget
    mean_len = min((4 + 128) / 2 + gen, 256)
    picks = {name: suggest_max_batch(serve_cfg, perf_model=pm,
                                     n_blocks=8 * 256 // 16, block_size=16,
                                     mean_len=mean_len)
             for name, pm in (("data sheet", sheet), ("fitted", fitted))}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-moe-30b-a3b", "--reduced", "--smoke", "--max-batch", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    lines = [x for x in out.stdout.splitlines()
             if x.startswith(("auto max-batch", "autosched[", "SERVE"))]
    if out.returncode or "SERVE SMOKE OK" not in out.stdout:
        raise AssertionError(f"phase 11 (g): the launcher failed: "
                             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    log(f"  (g) suggest_max_batch for phase 4's serving (128 blocks of 16, "
        f"mean length {mean_len:g}): {picks}; the launcher with "
        f"--max-batch 0: " + " | ".join(lines))
    return paths


# --- phase 12: Parm's schedules across ranks ----------------------------------

#: (a) the layer's cases: (name, mesh, schedule, pipeline_chunks, wire)
P12_MERGED = (("2x2", "merged"), (2, 2), ("data", "model"),
              dict(ep=("data",), esp=("model",), mp=("model",)))
P12_DISTINCT = (("2x2x2", "distinct"), (2, 2, 2), ("ep", "esp", "mp"),
                dict(ep=("ep",), esp=("esp",), mp=("mp",)))
P12_LAYER = {
    "merged": [("baseline", "baseline", 1, "f32"), ("s1", "s1", 1, "f32"),
               ("s2", "s2", 1, "f32"), ("s2h", "s2h", 1, "f32"),
               ("s1_seqpar", "s1_seqpar", 1, "f32"),
               ("s1g", "s1g", 1, "f32"), ("s1_pipe2", "s1", 2, "f32"),
               ("s2_pipe2", "s2", 2, "f32"), ("s1-bf16", "s1", 1, "bf16"),
               ("s1-fp8", "s1", 1, "fp8_e4m3"),
               ("s1g-bf16", "s1g", 1, "bf16"),
               ("s1g-fp8", "s1g", 1, "fp8_e4m3")],
    "distinct": [("baseline", "baseline", 1, "f32"), ("s1", "s1", 1, "f32"),
                 ("s2", "s2", 1, "f32"), ("decode", "s1", 1, "f32")],
}
#: the kernels each path must launch on every rank
P12_USES = {"s1g": ("moe_dispatch", "expert_ffn_ragged", "moe_combine"),
            "decode": ("expert_ffn",)}
P12_DEFAULT_USES = ("moe_dispatch", "expert_ffn", "moe_combine")
#: y against the one-rank layer: rtol 2e-4 / atol 2e-5 at f32 (the JAX
#: package's schedule-equivalence tolerance); gradients 2e-4 of their
#: largest entry (sums over 8192 tokens in other orders, and the ESP
#: partial sums).  A bf16 / fp8 wire rounds the ESP partial outputs where
#: the one-rank layer rounds their sum, so most elements move by a
#: rounding of their own size (57-98% of them beyond 2e-4 of the largest
#: entry on the CPU at 8 x 32 tokens: the CPU tests' 1% share rule holds
#: only against JAX, which rounds at the same points).  There y and every
#: gradient are held to one wire step (2^-7 bf16, 2^-3 e4m3) twice: every
#: element within that step of max(1, max |want|), and ||got - want|| /
#: ||want|| within it (read 3.5e-3 bf16 and 4.5e-2 fp8 at most on the
#: CPU; a wrong ESP reduction, a partial lost or counted twice, moves that
#: norm by 0.5 or more).
P12_WIRE = {"bf16": 2.0 ** -7, "fp8_e4m3": 2.0 ** -3}
P12_STEPS = 3
#: (b)'s schedules: baseline's layer is held in (a) on both meshes; its
#: training step moves ~3x s1's bytes through gloo (13.4 s a step against
#: s1's 4.5 s on the H100) and is left out of (b) to keep the phase short
P12_TRAIN_SCHEDS = ("s1", "s2")
#: (b)'s depth: gpt2-moe cut from 12 layers to 2 (one dense block, one
#: MoE block), so that (e) and (f) fit the phase's time; the 10 layers
#: left out repeat the same two blocks' shapes and collectives
P12_TRAIN_LAYERS = 2


#: the schedules that have a closed form (the paper's Eq. 1, 11, 14),
#: held in 12 (a) and in 14 (c)'s schedule_comparison rows
CLOSED = ("baseline", "s1", "s2", "s1_seqpar")


def expected_volumes(sched: str, cfg, tokens: int, mesh, dims,
                     el: int = 4) -> dict:
    """What one forward of the MoE layer ``cfg`` under ``sched`` (one of
    :data:`CLOSED`; one chunk) moves on a rank of ``mesh`` over ``tokens``
    global tokens of ``el``-byte elements, as
    ``schedule_comparison.volumes`` records it (HLO kind -> {group axes:
    (count, result bytes)}).  The paper's closed forms, with S the tokens
    of a data rank and T the per-expert capacity of its pool, derived here
    from the gate's parameters and not from the port's code: k f S / E
    rounded up to a multiple of 8, then of max(8, N_MP):

      baseline (Eq. 1):  AG(S M N_ESP) + AR(E T M N_ESP) + 2 A2A(E T M N_ESP)
      S1 (Eq. 11):       2 A2A(E T M N_ESP / N_MP) + AG(S M)
      S2 (Eq. 14):       2 A2A(E T M N_ESP / N_MP) + AG(E T M), the combine
                         AlltoAll and the AllGather in ``saa_chunks``
                         pieces each (SAA)
      s1_seqpar:         S1's AlltoAlls; no MP collective in the plan

    and what the port's eager layer moves beside them: the means of the
    aux outputs over every axis (the aux and z losses, the drop fraction
    and ``expert_load``: four all-reduces of 3 + E elements in all), which
    JAX's jit drops where the caller discards them, and under
    ``s1_seqpar`` the AllGather of the output's rows over MP (the port's
    layer returns this rank's batch block whole on every MP rank, where
    JAX's shard_map leaves it split)."""
    from repro_torch.parallel.mesh import axis_size
    sizes = dims.sizes(mesh)
    ne, ns, nm = sizes["ep"], sizes["esp"], sizes["mp"]
    S = tokens // axis_size(mesh, dims.batch_axes)
    E, M, n = cfg.n_experts, cfg.d_model, cfg.saa_chunks
    c = int(-(-cfg.top_k * cfg.capacity_factor * S // E))
    align = max(8, nm)
    T = max(align, -(-max(8, -(-c // 8) * 8) // align) * align)
    ep, esp, mp = tuple(dims.ep), tuple(dims.esp), tuple(dims.mp)
    fused = tuple(dict.fromkeys(ep + esp))
    a2a = 2 * E * T * M * ns // nm * el
    plan = {
        "baseline": {"all-gather": {esp: (1, S * M * ns * el)},
                     "all-reduce": {esp: (1, E * T * M * ns * el)},
                     "all-to-all": {ep: (2, 2 * E * T * M * ns * el)}},
        "s1": {"all-to-all": {fused: (2, a2a)},
               "all-gather": {mp: (1, S * M * el)}},
        "s2": {"all-to-all": {fused: (1 + n, a2a)},
               "all-gather": {mp: (n, E * T * M * el)}},
        "s1_seqpar": {"all-to-all": {fused: (2, a2a)}},
    }[sched]
    every = tuple(mesh.axis_names)
    plan.setdefault("all-reduce", {})[every] = (4, (3 + E) * el)
    if sched == "s1_seqpar":
        plan["all-gather"] = {mp: (1, S * M * el)}
    return plan


def check_volumes(rows: list, mesh, dims, tokens: int, cfg) -> list:
    """Hold each one-chunk row of a :data:`CLOSED` schedule (rows of
    ``schedule_comparison.compare``) to :func:`expected_volumes`, group by
    group, count and bytes exactly (raises ``AssertionError``); returns a
    line per row held."""
    from repro_torch.examples.schedule_comparison import totals
    lines = []
    for row in rows:
        if row["schedule"] not in CLOSED or row["chunks"] != 1:
            continue
        want = expected_volumes(row["schedule"], cfg, tokens, mesh, dims)
        if row["volumes"] != want:
            raise AssertionError(f"{row['label']}: collectives "
                                 f"{row['volumes']}, the closed form "
                                 f"{want}")
        nbytes, _ = totals(row["volumes"])
        by_kind = {k: sum(b for _, b in groups.values())
                   for k, groups in sorted(row["volumes"].items())}
        lines.append(f"{row['schedule']} {nbytes} {by_kind}")
    return lines


def _p12_cfg(model_cfg, schedule="s1g", n_chunks=1, wire="f32"):
    """``model_cfg``'s MoE layer at the drop-free capacity factor E / k."""
    from dataclasses import replace

    from repro_torch.core.collectives import CommConfig
    m = model_cfg.moe
    return replace(m, capacity_factor=m.n_experts / m.top_k,
                   schedule=schedule, pipeline_chunks=n_chunks,
                   comm=CommConfig(wire_dtype=wire))


def _p12_device():
    import torch
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


def _p12_layer_refs(dev, path, model_cfg, tokens):
    """(a)'s inputs and one-rank references, saved to ``path``: params,
    x (8 x 1024 global tokens) and the cotangent r, and per wire the
    one-rank s1g layer's y, routed rows and gradients of sum(y * r); the
    4-token decode pool's y."""
    import torch
    from repro_torch.core.moe import apply_moe, init_moe_params
    cfg = _p12_cfg(model_cfg)
    g = torch.Generator(device=dev).manual_seed(12)
    params = init_moe_params(g, cfg)
    x = torch.randn((*tokens, cfg.d_model), generator=g, device=dev)
    r = torch.randn((*tokens, cfg.d_model), generator=g, device=dev)
    xd = torch.randn((4, 1, cfg.d_model), generator=g, device=dev)
    ref = {"params": {k: v.cpu() for k, v in params.items()},
           "x": x.cpu(), "r": r.cpu(), "xd": xd.cpu()}
    for wire in ("f32", "bf16", "fp8_e4m3"):
        xs = x.clone().requires_grad_()
        ps = {k: v.clone().requires_grad_() for k, v in params.items()}
        y, aux = apply_moe(xs, ps, cfg=_p12_cfg(model_cfg, wire=wire))
        grads = torch.autograd.grad((y * r).sum(), [xs, *ps.values()])
        ref[wire] = {"y": y.detach().cpu(), "load": aux["expert_load"].cpu(),
                     "g": {k: v.cpu() for k, v in
                           zip(["x", *ps.keys()], grads)}}
    with torch.no_grad():
        ref["yd"] = apply_moe(xd, params, cfg=_p12_cfg(model_cfg),
                              infer=True)[0].cpu()
    torch.save(ref, path)
    del params, x, r, ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _p12_err(got, want):
    """The readings of ``got`` against ``want``: max |d| (``err``), the
    scale max(1, max |want|), the share of elements with |d| above 2e-4 of
    the scale, ||d|| / ||want|| (``rel``), whether every element holds
    |d| <= 2e-5 + 2e-4 |want| (``elem_ok``)."""
    w = want.float()
    d = (got.float() - w).abs()
    scale = max(1.0, float(w.abs().max()))
    return {"err": float(d.max()), "scale": scale,
            "share": float((d > 2e-4 * scale).float().mean()),
            "rel": float(d.norm() / w.norm().clamp_min(1e-30)),
            "elem_ok": bool((d <= 2e-5 + 2e-4 * w.abs()).all())}


def _p12_ok(r, wire, is_y):
    """Whether the readings ``r`` of one tensor meet ``P12_WIRE``'s
    limits (f32: y elementwise, a gradient 2e-4 of its largest entry)."""
    step = P12_WIRE.get(wire)
    if step is None:
        return r["elem_ok"] if is_y else r["err"] <= 2e-4 * r["scale"]
    return r["err"] <= step * r["scale"] and r["rel"] <= step


def _p12_layer_rank(rank, kind, ref_path, model_cfg, with_h=False):
    """(a) on one rank: every case of ``kind``'s mesh, each rank's output
    and gradient blocks read here against the one-rank references'
    blocks (``_p12_err``).  Returns per case the readings, the load check,
    the launches and the host ms of the forward and backward with each
    collective's host seconds (after one untimed warm-up case); with
    ``with_h`` also (h)'s readings on the same layer (``_p12_measured``),
    (i)'s placed runs of it (``_p12_placed_layer``) and (j)'s overlapped
    and serial runs (``_p12_overlap``)."""
    import torch
    from repro_torch.core.moe import apply_moe, moe_param_specs
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    from repro_torch.train.loop import sync_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _p12_device()
    _, shape, names, dkw = P12_MERGED if kind == "merged" else P12_DISTINCT
    mesh = make_mesh(shape, names)
    dims = ParallelDims(**dkw)
    # memory-mapped: each rank reads only its blocks of the 1.1 GB file
    ref = torch.load(ref_path, weights_only=False, mmap=True)
    base = _p12_cfg(model_cfg)
    specs = moe_param_specs(base, mesh, dims)
    xspec = P(dims.batch_axes, None, None)
    # each forward's collectives (with ``comm.timing`` on): the merged
    # mesh's one-chunk f32 baseline, s1, s2 and s1_seqpar are held to the
    # paper's closed forms (``expected_volumes``)
    from repro_torch.examples import schedule_comparison
    fwd_vol = {}

    def block(t, spec):
        return local_shard(t, spec, mesh).to(dev)

    def run(sched, n_chunks, wire, infer, placement=None, events=None):
        """One case forward and backward; ``events`` (a list) records
        ``comm``'s starts and waits, and ``P12_FWD_END`` between the
        forward's and the backward's."""
        if events is None:
            return one(sched, n_chunks, wire, infer, placement, None)
        comm.set_hook(lambda *ev: events.append(ev))
        try:
            return one(sched, n_chunks, wire, infer, placement,
                       events.append)
        finally:
            comm.set_hook(None)

    def one(sched, n_chunks, wire, infer, placement, mark):
        from dataclasses import replace
        cfg = replace(_p12_cfg(model_cfg, sched, n_chunks, wire),
                      placement=placement)
        p = {k: block(v, specs[k]).requires_grad_(not infer)
             for k, v in ref["params"].items()}
        x = block(ref["xd" if infer else "x"], xspec)
        if infer:
            with torch.no_grad():
                y, aux = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims,
                                   infer=True)
            return y, aux, {}
        x.requires_grad_()
        y, aux = apply_moe(x, p, cfg=cfg, mesh=mesh, dims=dims)
        fwd_vol["last"] = schedule_comparison.volumes()
        if mark is not None:
            mark(P12_FWD_END)
        r = block(ref["r"], xspec)
        keys = ["x", *p.keys()]
        gl = torch.autograd.grad((y * r).sum(), [x, *p.values()])
        gl = [gl[0]] + sync_grads(list(gl[1:]), [specs[k] for k in
                                                 keys[1:]], mesh, dims)
        return y, aux, dict(zip(keys, gl))

    _, sched, n_chunks, wire = P12_LAYER[kind][0]
    run(sched, n_chunks, wire, False)          # warm-up, not read
    out, kept, first = [], {}, {}
    for name, sched, n_chunks, wire in P12_LAYER[kind]:
        infer = name == "decode"
        # (j)'s overlapped side reads its first run here (the same case)
        events = [] if with_h and name in P12_OVERLAP_FROM_A else None
        wrappers = reset_counts()
        _sync(dev)
        comm.timing(True)
        t0 = time.perf_counter()
        y, aux, grads = run(sched, n_chunks, wire, infer, events=events)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        coll = comm.times()
        comm.timing(False)
        launches = read_counts(wrappers)
        if events is not None:
            first[name] = _p12_overlap_run(y, aux, grads, ms, coll,
                                           launches, events)
        want = ref["f32" if infer else wire]
        reads = {"y": _p12_err(y.detach(), block(
            ref["yd"] if infer else want["y"], xspec))}
        for k, gk in grads.items():
            reads[k] = _p12_err(gk, block(want["g"][k],
                                          xspec if k == "x" else specs[k]))
        # expert_load is the pmean of the pools' routed rows: each token is
        # gated by ``mult`` ranks' pools (1 under s1, n_mp under s2, ...),
        # so load * N = mult * (the one-rank layer's rows), exactly
        load_ok, mult = True, None
        if not infer:
            tot = aux["expert_load"].cpu() * mesh.size
            mult = float(tot.sum() / want["load"].sum())
            load_ok = mult == round(mult) and torch.equal(
                tot, want["load"] * round(mult))
        out.append({"name": name, "wire": wire, "reads": reads,
                    "load_ok": load_ok, "mult": mult, "launches": launches,
                    "ms": ms, "comm": coll})
        if kind == "merged" and name in CLOSED:
            out[-1]["volumes"] = fwd_vol["last"]
            out[-1]["closed_form"] = expected_volumes(
                sched, _p12_cfg(model_cfg, sched), ref["x"].shape[0]
                * ref["x"].shape[1], mesh, dims)
        if with_h and name in P12_PLACED_SCHEDS:
            kept[name] = (y.detach(), {k: v.detach() for k, v in
                                       aux.items()}, grads)
        del y, grads
    if not with_h:
        return out
    overlap = _p12_overlap(run, first, dev)
    del first
    placed = _p12_placed_layer(run, kept, mesh, dims, model_cfg, dev)
    del kept
    p = {k: block(v, specs[k]) for k, v in ref["params"].items()}
    return out, _p12_measured(mesh, dims, p, block(ref["x"], xspec),
                              model_cfg, dev), placed, overlap


#: (h): the measured calibration's grid on (a)'s layer, then the picked
#: schedule with an ``"auto"`` wire through ``apply_moe`` (2 candidates:
#: the pick on the f32 and bf16 wires); the kernels it must launch
P12_MEASURED_GRID = ("s1", "s2", "s1g", "s2h")
P12_MEASURED_USES = ("moe_dispatch", "moe_combine")


def _p12_measured(mesh, dims, p, x, model_cfg, dev):
    """(h) on one rank: ``autosched.decide`` in measured mode over
    ``P12_MEASURED_GRID`` on the live mesh (every rank times every
    candidate once after a warm-up call, each takes the slowest rank's
    time), then (a)'s layer
    under the pick with an ``"auto"`` wire, decided by measurement in
    ``apply_moe``, against the same schedule and wire forced.  Returns the
    times and picks, whether the two outputs are ``torch.equal``, the
    launches and the seconds."""
    from dataclasses import replace

    import torch
    from repro_torch.core import autosched
    from repro_torch.core.collectives import CommConfig
    from repro_torch.core.moe import apply_moe, shard_pool_capacity
    from repro_torch.core.perfmodel import MoELayerShape
    t0 = time.perf_counter()
    wrappers = reset_counts()
    cfg = _p12_cfg(model_cfg)
    sizes = dims.sizes(mesh)
    B, L = x.shape[0] * sizes["ep"], x.shape[1]
    s_local, _ = shard_pool_capacity(B * L, sizes["ep"], sizes["mp"],
                                     cfg.gate_config())
    shape = MoELayerShape(B=max(s_local // L, 1), L=min(L, s_local),
                          M=cfg.d_model, H=cfg.d_ff, E=cfg.n_experts,
                          k=cfg.top_k, f=cfg.capacity_factor,
                          n_mp=sizes["mp"], n_esp=sizes["esp"],
                          n_ep=sizes["ep"])
    d = autosched.decide(shape, mode="measured", chunk_candidates=(1,),
                         schedules=P12_MEASURED_GRID,
                         measure=autosched.measure_candidates(
                             cfg, tokens=B * L, d_model=cfg.d_model,
                             device=dev, mesh=mesh, dims=dims, iters=1))
    auto = replace(cfg, schedule=d.schedule, autosched="measured",
                   comm=CommConfig(wire_dtype="auto"))
    with torch.no_grad():
        y, _ = apply_moe(x, p, cfg=auto, mesh=mesh, dims=dims)
        (w,) = [v for k, v in autosched.cache_info().items()
                if k[1] == "measured" and k[4] == autosched.AUTO_WIRE]
        forced = replace(cfg, schedule=w.schedule,
                         comm=CommConfig(wire_dtype=w.wire_dtype))
        yf, _ = apply_moe(x, p, cfg=forced, mesh=mesh, dims=dims)
    _sync(dev)
    return {"times": d.times, "pick": d.schedule, "wire_times": w.times,
            "wire": (w.schedule, w.wire_dtype),
            "equal": bool(torch.equal(y, yf)),
            "launches": read_counts(wrappers),
            "s": time.perf_counter() - t0}


#: (i): expert placement on the mesh.  The layer: (a)'s merged layer under
#: these schedules with ``p12_placements``' three placements, each against
#: (a)'s unplaced run of the same schedule (identity ``torch.equal``; rep2
#: and hot (a)'s f32 tolerances, the drop mask, ``expert_load`` and
#: ``drop_frac`` exact), each schedule's kernels (``P12_USES``) launched on
#: every rank
P12_PLACED_SCHEDS = ("s1", "s1g")
#: (i)'s training: (b)'s gpt2-moe (2 layers, factor E / k) under
#: ``schedule="auto"`` and ``placement="auto"``, ``rebalance_every=1``,
#: these steps (the swap after step 1), the gate skewed toward expert 0
#: through the sinusoidal positions' cosine features: ``wg[1::2, 0] +=
#: P12_PLACED_SKEW`` (the position code is the part of a gpt2 token's
#: normalised input that every token shares; a constant added to the whole
#: column would be cancelled by the layernorm's centring)
P12_PLACED_STEPS = 4
P12_PLACED_SKEW = 0.3


def p12_placements(n_experts, n_ep):
    """(i)'s placements (``tests/helpers/run_placement_parity.py``'s):
    identity; rep2, every expert twice on distinct EP ranks at half
    capacity (the effective capacities the unplaced ones); hot, expert 0
    on every spare slot at full capacity."""
    from repro_torch.core.placement import ExpertPlacement, identity_placement
    E = n_experts
    per = 2 * E // n_ep
    R = -(-(E + n_ep - 1) // n_ep) * n_ep + n_ep
    return {"identity": identity_placement(E, n_ep),
            "rep2": ExpertPlacement(E, n_ep, tuple(
                (r * (E // n_ep) + i) % E for r in range(n_ep)
                for i in range(per)), cap_frac=0.5),
            "hot": ExpertPlacement(E, n_ep, tuple(
                sorted([0] * (R - E + 1) + list(range(1, E)))),
                cap_frac=1.0)}


def _p12_exchange_bytes(pl, mesh, dims, blocks):
    """Bytes this rank's placed weights' exchange sends to the other EP
    ranks, each way (``blocks``: this rank's expert weight blocks)."""
    from repro_torch.core.moe import _SlotExchange
    grp = mesh.group(dims.ep)
    x = _SlotExchange(pl, grp)
    rows = sum(len(v) for j, v in enumerate(x.send_idx) if j != grp.index)
    return sum(rows * w[0].numel() * w.element_size() for w in blocks)


def _p12_placed_layer(run, base, mesh, dims, model_cfg, dev):
    """(i)'s layer on one rank of the merged mesh: ``run``
    (``_p12_layer_rank``'s) under each of ``P12_PLACED_SCHEDS`` and
    ``p12_placements``, read against (a)'s unplaced run of the schedule
    (``base``: y, aux, gradients).  Returns per case the check, readings,
    launches, host ms, the exchange's bytes off the rank each way and
    each collective's host seconds."""
    import torch
    from repro_torch.parallel import comm
    n_ep = dims.sizes(mesh)["ep"]
    out = []
    for sched in P12_PLACED_SCHEDS:
        yb, auxb, gb = base[sched]
        for name, pl in p12_placements(model_cfg.moe.n_experts,
                                       n_ep).items():
            wrappers = reset_counts()
            _sync(dev)
            comm.timing(True)
            t0 = time.perf_counter()
            y, aux, grads = run(sched, 1, "f32", False, placement=pl)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            coll = comm.times()
            comm.timing(False)
            launches = read_counts(wrappers)
            y = y.detach()
            if name == "identity":
                reads = {}
                ok = (torch.equal(y, yb)
                      and all(torch.equal(aux[k], auxb[k]) for k in auxb)
                      and all(torch.equal(grads[k], gb[k]) for k in gb))
            else:
                reads = {"y": _p12_err(y, yb)}
                reads.update({k: _p12_err(g, gb[k])
                              for k, g in grads.items()})
                ok = (torch.equal((y == 0).all(-1), (yb == 0).all(-1))
                      and torch.equal(aux["expert_load"],
                                      auxb["expert_load"])
                      and torch.equal(aux["drop_frac"], auxb["drop_frac"])
                      and all(_p12_ok(r, "f32", k == "y")
                              for k, r in reads.items()))
            out.append({"sched": sched, "name": name, "ok": ok,
                        "reads": reads, "launches": launches, "ms": ms,
                        "R": pl.n_phys, "cap_frac": pl.cap_frac,
                        "bytes": _p12_exchange_bytes(
                            pl, mesh, dims, [gb[k] for k in ("w1", "w2",
                                                             "w3")
                                             if k in gb]),
                        "comm": coll})
            del y, aux, grads
    return {"layer": out}


def _p12_placed_train(rank, model_cfg, tokens, tmp):
    """(i)'s training on one rank of the merged mesh: the skewed gpt2-moe
    (``P12_PLACED_SKEW``) first unplaced for the steps before the swap,
    then under ``placement="auto"`` with ``rebalance_every=1`` (this
    rank's events in a sink of its own under ``tmp``).  Returns both runs'
    losses and step ms, the ``train_rebalance`` events, the modeled times
    of the swap (``autosched.last_rebalance_times``) and the launches
    after it."""
    from dataclasses import replace

    import torch
    from repro_torch import obs
    from repro_torch.core import autosched
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.obs.sink import read_events
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.train import Trainer
    dev = _p12_device()
    cfg = _p12_train_cfg(model_cfg)
    cfg = replace(cfg, moe=replace(cfg.moe, placement="auto"))
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tokens[1], global_batch=tokens[0]))

    def run(placement, steps):
        autosched.clear_cache()
        tr = Trainer(Model(cfg, device=dev), AdamWConfig(
            lr=1e-3, warmup_steps=2, total_steps=P12_PLACED_STEPS),
            mesh=mesh, dims=dims, placement=placement, rebalance_every=1)
        params, opt = tr.setup(torch.Generator(device=dev).manual_seed(0))
        with torch.no_grad():
            for r in params.values():
                if isinstance(r, dict) and "moe" in r:
                    r["moe"]["wg"][..., 1::2, 0] += P12_PLACED_SKEW
        _sync(dev)
        with contextlib.redirect_stdout(io.StringIO()):   # step lines
            _, _, hist = tr.run(params, opt, data, steps, log_every=1)
        _sync(dev)
        walls = [h["wall_s"] for h in hist]
        return ([h["loss"] for h in hist],
                [1e3 * (b - a) for a, b in zip([0.0] + walls, walls)])

    out = {}
    out["plain_loss"], out["plain_ms"] = run(None, 2)
    swaps = []
    set_placement = autosched.set_placement

    def swapping(pl):
        # the kernels' launches from the first swap on
        if not swaps:
            reset_counts()
        swaps.append(autosched.last_rebalance_times())
        return set_placement(pl)

    autosched.set_placement = swapping
    obs.configure(os.path.join(tmp, str(rank)), meta={"kind": "train"})
    try:
        out["loss"], out["ms"] = run("auto", P12_PLACED_STEPS)
        paths = list(obs.get_sink().paths)
    finally:
        autosched.set_placement = set_placement
        obs.close()
    out["launches"] = read_counts(kernel_wrappers())
    out["events"] = [{k: e[k] for k in ("step", "epoch", "placement")}
                     for e in read_events(paths)
                     if e["event"] == "train_rebalance"]
    out["priced"] = [[(s, n, tp, tu) for _, s, n, tp, tu in p]
                     for p in swaps]
    autosched.clear_cache()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def p12_serve_placement(load, n_ep):
    """(i)'s serving placement: the two experts that ``load`` (rank 0's
    one-rank prefill's routed rows) names most, each replicated onto an EP
    rank other than its own, ranks evened out by moving a cold expert; R =
    E + 2 slots at full capacity."""
    import numpy as np
    from repro_torch.core.placement import ExpertPlacement
    E = len(load)
    El = E // n_ep
    hot = [int(e) for e in np.argsort(-np.asarray(load), kind="stable")[:2]]
    ranks = [list(range(r * El, (r + 1) * El)) for r in range(n_ep)]
    for i, h in enumerate(hot):
        to = (h // El + 1 + i) % n_ep
        ranks[(to + 1) % n_ep if to == h // El else to].append(h)
    per = (E + 2) // n_ep
    for r in range(n_ep):
        while len(ranks[r]) > per:
            cold = max(e for e in ranks[r] if e not in hot)
            ranks[r].remove(cold)
            min(ranks, key=len).append(cold)
    return hot, ExpertPlacement(E, n_ep, tuple(
        e for r in ranks for e in sorted(r)))


def _p12_placed_serve(rank, block_cfg, params, ref_path):
    """(i)'s serving on one rank of the (2, 2) mesh: (g)'s requests under
    ``auto`` with ``p12_serve_placement`` installed by
    ``autosched.set_placement``, read against rank 0's one-rank engine by
    (g)'s rule.  Returns the readings, the placement, which pools ran it
    (``moe.resolve_placement``'s results by pool kind), the launches and
    the host seconds."""
    from dataclasses import replace

    import torch
    from repro_torch.core import autosched
    from repro_torch.core import moe as moe_mod
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import make_mesh
    dev = _p12_device()
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(block_cfg)
    prompts = p12_serve_prompts(block_cfg.vocab_size)
    ref = torch.load(ref_path, weights_only=False)
    hot, pl = p12_serve_placement(ref["prefill_load"].tolist(),
                                  dims.sizes(mesh)["ep"])
    cfg = p12_serve_cfg(block_cfg)
    model = Model(replace(cfg, moe=replace(cfg.moe, placement="auto")),
                  device=dev)
    pools = {}
    resolve = moe_mod.resolve_placement

    def recording(cfg, n_ep, use_fallback, infer):
        got = resolve(cfg, n_ep, use_fallback, infer)
        key = ("decode" if infer else "prefill",
               "dense_decode" if use_fallback else
               "placed" if got is not None else "uniform")
        pools[key] = pools.get(key, 0) + 1
        return got

    autosched.clear_cache()
    autosched.set_placement(pl)
    moe_mod.resolve_placement = recording
    try:
        wrappers = reset_counts()
        done, eng, wall, rec = _p12_serve(model, params, prompts, mesh, dims)
        launches = read_counts(wrappers)
    finally:
        moe_mod.resolve_placement = resolve
        autosched.clear_cache()
    out = _p12_read_serve(done, eng, rec, ref, prompts)
    out.update(hot=hot, R=pl.n_phys, assignments=list(pl.assignments),
               pools={f"{a} {b}": n for (a, b), n in sorted(pools.items())},
               launches=launches, wall=wall)
    return out


def _p12_placed_report(res):
    """(i)'s checks and log lines from each rank's runs; returns {path:
    per-rank launches}."""
    paths, failed = {}, []
    for i, case in enumerate(res[0]["layer"]):
        cases = [r["layer"][i] for r in res]
        per_rank = {k: [c["launches"][k] for c in cases]
                    for k in case["launches"]
                    if any(c["launches"][k] for c in cases)}
        uses = P12_USES.get(case["sched"], P12_DEFAULT_USES)
        bad = [k for k in uses if min(per_rank.get(k, [0])) < 1]
        ok = all(c["ok"] for c in cases) and not bad
        worst = {k: max((c["reads"][k] for c in cases),
                        key=lambda r: r["err"] / r["scale"])
                 for k in case["reads"]}
        xchg = [(c["bytes"], c["comm"].get("all_to_all_rows"))
                for c in cases]
        log(f"  (i) layer {case['sched']} {case['name']} (R={case['R']}, "
            f"cap_frac {case['cap_frac']:g}): "
            + ("torch.equal to (a)'s unplaced run (y, aux, gradients)"
               if case["name"] == "identity" else
               "; ".join(f"{k} max_abs_err {r['err']:.3e}"
                         for k, r in worst.items())
               + "; drop mask, expert_load and drop_frac exact")
            + f"; launches per rank {per_rank}; host ms "
            + ", ".join(f"{c['ms']:.1f}" for c in cases)
            + "; the weights' exchange per rank "
            + ", ".join(f"{b / 1e6:.1f} MB each way"
                        + (f" ({t[0]} calls, {1e3 * t[2]:.1f} ms)" if t
                           else " (no call)") for b, t in xchg)
            + ("" if ok else f" FAILED (kernels {bad} not on every rank)"))
        if not ok:
            failed.append(f"layer {case['sched']} {case['name']}")
        paths[f"placement_2x2_{case['sched']}_{case['name']}"] = per_rank
    # training: the swap, the same placement on every rank
    tr = [r["train"] for r in res]
    t0 = tr[0]
    same = all(t["events"] == t0["events"] for t in tr)
    first = t0["events"][0] if t0["events"] else None
    # a swap with placed steps after it; the steps up to it are unplaced
    swapped = first is not None and first["step"] < P12_PLACED_STEPS - 1
    before = min(len(t0["plain_loss"]), first["step"] + 1 if first else 0)
    plain_ok = before > 0 and all(
        t["loss"][:before] == t["plain_loss"][:before] for t in tr)
    finite = all(math.isfinite(x) for t in tr for x in t["loss"])
    per_rank = {k: [t["launches"][k] for t in tr] for k in t0["launches"]
                if any(t["launches"][k] for t in tr)}
    bad = [k for k in P12_USES["s1g"] if min(per_rank.get(k, [0])) < 1]
    priced = t0["priced"][0] if t0["priced"] else []
    log(f"  (i) training, gpt2-moe {P12_TRAIN_LAYERS} layers under auto, "
        f"wg[1::2, 0] += {P12_PLACED_SKEW}: train_rebalance "
        + (f"at step {first['step']} -> epoch {first['epoch']}, "
           f"{first['placement']}" if first else "none")
        + f" ({len(t0['events'])} in {P12_PLACED_STEPS} steps, the same on "
        f"every rank: {same}); h100_model "
        + ", ".join(f"{s} x{n}: t_placed {1e3 * tp:.4f} ms, t_uniform "
                    f"{1e3 * tu:.4f} ms" for s, n, tp, tu in priced)
        + "; losses " + " ".join(f"{x:.6f}" for x in t0["loss"])
        + f" (unplaced {' '.join(f'{x:.6f}' for x in t0['plain_loss'])}, "
        f"the first {before} equal on every rank: {plain_ok}); step ms per "
        f"rank " + "; ".join(" ".join(f"{m:.1f}" for m in t["ms"])
                              for t in tr)
        + f"; launches after the first swap per rank {per_rank}; "
        f"{max(r['train_s'] for r in res):.1f} s")
    if not (same and swapped and plain_ok and finite) or bad:
        failed.append(f"training (same {same}, swap at step "
                      f"{first and first['step']}, before the swap "
                      f"{plain_ok}, finite {finite}, kernels {bad})")
    paths["placement_2x2_train"] = per_rank
    # serving under the installed placement
    sv = [r["serve"] for r in res]
    s0 = sv[0]
    per_rank = {k: [s["launches"][k] for s in sv] for k in s0["launches"]
                if any(s["launches"][k] for s in sv)}
    bad = [k for k in P12_SERVE_USES["auto"]
           if min(per_rank.get(k, [0])) < 1]
    log(f"  (i) serving (g)'s requests under auto with experts {s0['hot']} "
        f"(rank 0's one-rank prefill's two most routed) replicated, R = "
        f"{s0['R']}: pools {s0['pools']}; first logits max_abs_err "
        f"{max(s['first_err'] for s in sv):.3e}; streams off the one-rank "
        f"run at a top-2 tie: {sum(len(s['ties']) for s in sv)}; "
        + ", ".join(f"rank {rk} {s['latency']['tok_per_s']:.1f} tok/s"
                    for rk, s in enumerate(sv))
        + f"; launches per rank {per_rank}; "
        f"{max(r['serve_s'] for r in res):.1f} s")
    n = len(p12_serve_prompts(10))
    bad_rk = [rk for rk, s in enumerate(sv) if not (
        s["complete"] and s["live"] == 0 and s["first_ok"] and not s["off"]
        and s["pools"] == s0["pools"]
        and any(k.endswith(" placed") for k in s["pools"])
        and s["stats"]["prefill_calls"] == s["stats"]["admitted"] == n)]
    if bad_rk or bad:
        failed.append(f"serving (ranks {bad_rk}, kernels {bad})")
    paths["placement_2x2_serve"] = per_rank
    if failed:
        raise AssertionError(f"phase 12 (i): {failed} (the lines above)")
    return paths


def _p12_merged_rank(rank, ref_path, model_cfg, scheds, steps, tokens,
                     block_cfg, block_tokens, guard_dir, kv_cfg, kv_ref,
                     rzoo_ref, xzoo_ref):
    """One rank of the merged (2, 2) mesh: (a)'s cases, (j)'s overlapped
    and serial runs, (i)'s placed layer and (h) on the same layer, then
    (b) and (c), then (d) on both of its
    meshes, (g) and (i)'s serving with (d)'s weights, (i)'s training, then
    (e) and (f), then (k), then (l), then (m), in one spawn."""
    layer, measured, placed, overlap = _p12_layer_rank(
        rank, "merged", ref_path, model_cfg, with_h=True)
    out = {"layer": layer, "measured": measured, "overlap": overlap,
           "train": _p12_train_rank(rank, scheds, steps, model_cfg,
                                    tokens)}
    serve_ref = guard_dir + "_serve_ref.pt"
    out["block"], params = _p12_block_rank(rank, block_cfg, block_tokens,
                                           serve_ref)
    out["serve"] = _p12_serve_rank(rank, block_cfg, params, serve_ref)
    t0 = time.perf_counter()
    placed["serve"] = _p12_placed_serve(rank, block_cfg, params, serve_ref)
    del params
    placed["serve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    placed["train"] = _p12_placed_train(rank, model_cfg, tokens,
                                        guard_dir + "_placed")
    placed["train_s"] = time.perf_counter() - t0
    out["placed"] = placed
    out["guarded"] = _p12_guarded_rank(rank, model_cfg, tokens, guard_dir)
    out["kv"] = _p12_kv_rank(rank, kv_cfg, kv_ref)
    t0 = time.perf_counter()
    out["rzoo"] = _p12_rzoo_rank(rank, rzoo_ref)
    out["rzoo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["xzoo"] = _p12_xzoo_rank(rank, xzoo_ref)
    out["xzoo_s"] = time.perf_counter() - t0
    return out


#: (j): the overlapped issue of the layer's collectives (``execute``'s
#: list scheduler) on (a)'s merged layer, forward and backward, against
#: its serial twin (``executor.serial_issue``): (name, schedule,
#: pipeline_chunks, wire); ``s2`` is SAA at 4 chunks
P12_OVERLAP = (("s1_pipe2", "s1", 2, "f32"), ("s2_pipe2", "s2", 2, "f32"),
               ("s2h_pipe2", "s2h", 2, "f32"),
               ("s1g_pipe2", "s1g", 2, "f32"), ("s2", "s2", 1, "f32"),
               ("s1_pipe2-fp8", "s1", 2, "fp8_e4m3"))
#: (a)'s runs of these cases are (j)'s overlapped side's first run
P12_OVERLAP_FROM_A = ("s1_pipe2", "s2_pipe2", "s2")
#: the cases whose backward must show two collectives in flight at once
P12_OVERLAP_BACKWARD = ("s1_pipe2", "s2")
#: each issue mode's runs of a case (the first records the hook; the
#: fastest is read)
P12_OVERLAP_RUNS = 3
#: what a recording run puts between its forward's and backward's events
P12_FWD_END = ("forward returned",)


def _p12_in_flight(events) -> int:
    """The most collectives in flight at once in ``events`` (``comm``'s
    hook records: (event, axes, kind, tag))."""
    n = most = 0
    for ev in events:
        n += 1 if ev[0] == "start" else -1
        most = max(most, n)
    return most


def _p12_overlap_run(y, aux, grads, ms, coll, launches, events=None):
    """One (j) run: its host ms, the collectives' summed and in-flight
    seconds and the launches; a recording run (``events``) also keeps y,
    aux and the gradients and the most in flight in its forward and in
    its backward."""
    run = {"ms": ms, "launches": launches,
           "summed_s": sum(v[2] for k, v in coll.items()
                           if k != "in_flight"),
           "in_flight_s": coll.get("in_flight", (0, 0, 0.0))[2]}
    if events is not None:
        cut = events.index(P12_FWD_END)
        run.update(y=y.detach(), grads=grads,
                   aux={k: v.detach() for k, v in aux.items()},
                   fwd=_p12_in_flight(events[:cut]),
                   bwd=_p12_in_flight(events[cut + 1:]))
    return run


def _p12_overlap(run, first, dev):
    """(j) on one rank of the merged mesh, after (a) (its warm-up
    included): each ``P12_OVERLAP`` case issued overlapped and serially,
    ``P12_OVERLAP_RUNS`` runs each, the first recording ``comm``'s hook
    (the overlapped side's first run is (a)'s where ``first`` holds it).
    Returns per case whether y, aux and every gradient are
    ``torch.equal`` across the modes, the most collectives in flight in
    each mode's forward and backward, the launches, and each mode's runs'
    host ms and summed and in-flight collective seconds; and (j)'s
    seconds."""
    import torch
    from repro_torch.core import executor
    from repro_torch.parallel import comm
    t_all = time.perf_counter()
    out = []
    for name, sched, n_chunks, wire in P12_OVERLAP:
        modes = {}
        for mode in ("overlap", "serial"):
            runs = [first[name]] if mode == "overlap" and name in first \
                else []
            while len(runs) < P12_OVERLAP_RUNS:
                events = None if runs else []
                wrappers = reset_counts()
                with (executor.serial_issue() if mode == "serial"
                      else contextlib.nullcontext()):
                    _sync(dev)
                    comm.timing(True)
                    t0 = time.perf_counter()
                    y, aux, grads = run(sched, n_chunks, wire, False,
                                        events=events)
                    _sync(dev)
                    ms = (time.perf_counter() - t0) * 1e3
                    coll = comm.times()
                    comm.timing(False)
                runs.append(_p12_overlap_run(y, aux, grads, ms, coll,
                                             read_counts(wrappers), events))
                del y, aux, grads
            modes[mode] = runs
        ov, se = modes["overlap"][0], modes["serial"][0]
        equal = (torch.equal(ov["y"], se["y"])
                 and all(torch.equal(ov["aux"][k], se["aux"][k])
                         for k in ov["aux"])
                 and all(torch.equal(ov["grads"][k], se["grads"][k])
                         for k in ov["grads"]))
        out.append({
            "name": name, "sched": sched, "equal": equal,
            "fwd": (ov["fwd"], se["fwd"]), "bwd": (ov["bwd"], se["bwd"]),
            "launches": {m: r[0]["launches"] for m, r in modes.items()},
            "runs": {m: [{k: x[k] for k in ("ms", "summed_s",
                                            "in_flight_s")} for x in r]
                     for m, r in modes.items()}})
        del modes, ov, se
    return {"cases": out, "s": time.perf_counter() - t_all}


def _p12_overlap_report(res):
    """(j)'s checks and log lines from each rank's ``_p12_overlap``: on
    every rank the overlapped run ``torch.equal`` the serial one (y, aux,
    every gradient), two or more collectives in flight in the overlapped
    forward (one in the serial), and in the backward of
    ``P12_OVERLAP_BACKWARD``, each path's kernels launched in both modes;
    each rank's best host ms and collective seconds per mode.  Returns
    {path: per-rank launches}."""
    paths, failed = {}, []
    for i, case in enumerate(res[0]["cases"]):
        name = case["name"]
        cases = [r["cases"][i] for r in res]
        per_rank = {k: [c["launches"]["overlap"][k] for c in cases]
                    for k in case["launches"]["overlap"]
                    if any(c["launches"]["overlap"][k] for c in cases)}
        bad = [k for k in P12_USES.get(case["sched"], P12_DEFAULT_USES)
               if min(c["launches"][m].get(k, 0) for c in cases
                      for m in ("overlap", "serial")) < 1]
        ok = (not bad and all(c["equal"] for c in cases)
              and all(c["fwd"][0] >= 2 and c["fwd"][1] == 1 for c in cases)
              and (name not in P12_OVERLAP_BACKWARD
                   or all(c["bwd"][0] >= 2 for c in cases)))
        log(f"  (j) {name}: overlapped torch.equal serial (y, aux, every "
            f"gradient): {[c['equal'] for c in cases]}; most in flight, "
            f"forward {[c['fwd'][0] for c in cases]} (serial "
            f"{[c['fwd'][1] for c in cases]}), backward "
            f"{[c['bwd'][0] for c in cases]} (serial "
            f"{[c['bwd'][1] for c in cases]}); launches per rank "
            f"{per_rank}" + ("" if ok else f" FAILED (not launched: {bad})"))
        for rk, c in enumerate(cases):
            best = {m: min(c["runs"][m], key=lambda x: x["ms"])
                    for m in ("overlap", "serial")}
            log(f"  (j) {name} rank {rk} (best of {P12_OVERLAP_RUNS}): "
                + "; ".join(f"{m} {b['ms']:.1f} ms, collectives summed "
                            f"{1e3 * b['summed_s']:.1f} ms, in flight "
                            f"{1e3 * b['in_flight_s']:.1f} ms"
                            for m, b in best.items()))
        if not ok:
            failed.append(name)
        paths[f"overlap_2x2_{name}"] = per_rank
    log(f"  (j) in {max(r['s'] for r in res):.1f} s")
    if failed:
        raise AssertionError(f"phase 12 (j): {failed} (the lines above)")
    return paths


#: (e): phase 9 (a)'s run on the (2, 2) mesh, 7 steps (0-6): the skips at
#: 3-5, the rollback at 4 past the bit-flipped step-2 file, the snapshot
#: at 6; the kernels it must launch on every rank (gpt2-moe's layernorm
#: launches no rmsnorm)
P12_GUARD_STEPS = 7
P12_GUARD_USES = ("moe_dispatch", "expert_ffn_ragged", "moe_combine",
                  "flash_attention")
P12_GUARD_HISTORY = [("snapshot", 0), ("snapshot", 2), ("rollback", 4),
                     ("snapshot", 6)]
#: (e)'s finite losses against phase 9 (a)'s, relative: the ranks round
#: the ESP partial outputs on the fp8 wire where one rank rounds their
#: sum, and each data rank's pool drops its own rows at the config's
#: capacity factor (1.2); the CPU rehearsal at reduced size (8 x 32
#: tokens) read 7.3e-4 at most
P12_GUARD_RTOL = 5e-3


def _p12_guarded_rank(rank, model_cfg, tokens, tmp):
    """(e) and (f) on one rank of the merged (2, 2) mesh: phase 9 (a)'s
    guarded run (``p9_config``: 4 layers, s1g, the fp8 wire) under
    ``PHASE9_FAULTS`` for ``P12_GUARD_STEPS`` steps, checkpoints in
    ``tmp``, rank 0's sink; then the retained step-6 file restored into
    fresh tensors on every rank and held ``torch.equal`` to the live
    shards; then (f, on a card) one clean guarded step profiled on every
    rank.  Returns the run's losses, events, history, launches, the
    agreement all-gathers' and each snapshot's and restore's seconds, the
    world's fp8 counts and the profile."""
    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import ckpt as ckptlib
    from repro_torch.launch.common import device_profile
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.runtime import FaultPlan, GuardConfig, fp8_sat_counts
    from repro_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    dev = _p12_device()
    cfg, data, opt = p9_config(model_cfg, tokens)
    mesh = make_mesh((2, 2), ("data", "model"))
    if rank == 0:
        obs.configure(os.path.join(tmp, "metrics"), meta={
            "phase": "12 (e)", "n_devices": mesh.size,
            "mesh": dict(mesh.shape)})
    tr = Trainer(Model(cfg, device=dev), opt, schedule="s1g",
                 ckpt_path=os.path.join(tmp, "run.npz"),
                 guards=GuardConfig(max_skips=2),
                 faults=FaultPlan.parse(PHASE9_FAULTS), ckpt_retain=2,
                 mesh=mesh, dims=dims_for(cfg))
    params, opt_state = tr.setup(torch.Generator(device=dev).manual_seed(0))
    secs = {"agree": [], "gather": [], "save": [], "restore": []}

    def timed(key, fn):
        def run(*args, **kw):
            n = len(secs["gather"])
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(dev)
            t = time.perf_counter() - t0
            secs[key].append((sum(secs["gather"][n:]), t)
                             if key == "save" else t)
            return out
        return run

    store = ckptlib.CheckpointStore
    saved = ckptlib.gather_to_first, store.save, store.restore
    tr._agree = timed("agree", tr._agree)
    ckptlib.gather_to_first = timed("gather", saved[0])
    store.save, store.restore = timed("save", saved[1]), timed(
        "restore", saved[2])
    wrappers = reset_counts()
    try:
        params, opt_state, hist = tr.run(params, opt_state, data,
                                         P12_GUARD_STEPS, log_every=1,
                                         ckpt_every=2)
        _sync(dev)
    finally:
        ckptlib.gather_to_first, store.save, store.restore = saved
    launches = read_counts(wrappers)
    metrics = None
    if rank == 0:
        metrics = list(obs.get_sink().paths)
        obs.close()
    mgr = tr.rollback_mgr
    path6 = mgr.store.path_of(P12_GUARD_STEPS - 1)
    live = {"params": params, "opt_state": opt_state}
    fresh = _zeros(live)
    _sync(dev)
    t0 = time.perf_counter()
    _, step6 = ckptlib.load_checkpoint(path6, into=fresh,
                                       specs=tr.state_specs(params),
                                       mesh=mesh)
    _sync(dev)
    restore6 = time.perf_counter() - t0
    same = step6 == P12_GUARD_STEPS - 1 and all(
        torch.equal(a, b) for a, b in zip(_leaves(fresh), _leaves(live)))
    del fresh
    out = {"losses": [h["loss"] for h in hist],
           "wall": [h["wall_s"] for h in hist],
           "events": tr.guard_state.events,
           "counters": dict(tr.guard_state.counters),
           "mgr": [(e["kind"], e["step"], os.path.basename(e.get("path",
                                                                   "")))
                   for e in mgr.events],
           "retained": mgr.store.steps(), "launches": launches,
           "secs": secs, "restore6": restore6, "same": same, "path6": path6,
           "bytes6": os.path.getsize(path6), "sat": fp8_sat_counts(),
           "metrics": metrics, "prof": None}
    if dev.type == "cuda":
        # (f) the launcher's --profile: one clean guarded step profiled on
        # every rank (they run its collectives together); its unprofiled
        # wall is the run's last step, a clean guarded step of this model
        wall_ms = (out["wall"][-1] - out["wall"][-2]) * 1e3
        batch = tr.batch(data, P12_GUARD_STEPS)
        prof = device_profile(lambda: tr.guarded_step(
            params, opt_state, batch, 1.0, 0.0), wall_ms, top=5)
        out["prof"] = {k: prof[k] for k in ("wall_ms", "busy_ms",
                                            "busy_share", "n_kernels",
                                            "top_ops")}
    del params, opt_state, live, tr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["total_s"] = time.perf_counter() - t_all
    return out


def _zeros(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree, requires_grad=False)


def p9_reference_losses(dev, g2, tokens, steps):
    """Phase 9 (a)'s losses when phase 9 did not run: its run, one rank,
    ``steps`` steps (no sink)."""
    import tempfile

    import torch
    from repro_torch.core import autosched, collectives
    from repro_torch.models import Model
    from repro_torch.runtime import (FaultPlan, GuardConfig,
                                     disable_fp8_monitor, reset_fp8_counter)
    from repro_torch.train import Trainer
    cfg, data, opt = p9_config(g2, tokens)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(Model(cfg, device=dev), opt, schedule="s1g",
                     ckpt_path=os.path.join(tmp, "run.npz"),
                     guards=GuardConfig(max_skips=2),
                     faults=FaultPlan.parse(PHASE9_FAULTS), ckpt_retain=2)
        params, opt_state = tr.setup(
            torch.Generator(device=dev).manual_seed(0))
        hist = tr.run(params, opt_state, data, steps, log_every=1,
                      ckpt_every=2)[2]
    autosched.set_wire_ceiling(None)
    collectives.set_fp8_sat_injection(0.0)
    disable_fp8_monitor()
    reset_fp8_counter()
    del tr, params, opt_state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return [h["loss"] for h in hist]


def _p12_guarded_report(res, ref_losses, dev, model_cfg, tokens):
    """(e)'s and (f)'s checks and log lines from each rank's
    ``_p12_guarded_rank``; ``ref_losses`` are phase 9 (a)'s.  Returns
    {path: per-rank launches}."""
    import math

    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.models import Model
    from repro_torch.obs.sink import read_events
    from repro_torch.optim import adamw_init
    counters = {**PHASE9_COUNTERS, "steps": P12_GUARD_STEPS}
    r0 = res[0]
    for rk, r in enumerate(res):
        events = [(e["kind"], e.get("step"), e.get("streak"),
                   e.get("restored_step")) for e in r["events"]]
        if (events != PHASE9_EVENTS or r["counters"] != counters
                or [m[:2] for m in r["mgr"]] != P12_GUARD_HISTORY
                or r["mgr"][2][2] != "run.step00000000.npz"
                or r["retained"] != [2, 6] or not r["same"]):
            raise AssertionError(
                f"phase 12 (e) rank {rk}: events {r['events']}, counters "
                f"{r['counters']}, history {r['mgr']}, retained "
                f"{r['retained']}, step-6 file equal to the shards "
                f"{r['same']}")
        if [x for x in r["losses"] if not math.isnan(x)] != [
                x for x in r0["losses"] if not math.isnan(x)]:
            raise AssertionError(f"phase 12 (e): rank {rk}'s losses "
                                 f"{r['losses']}, rank 0's {r0['losses']}")
    losses, want = r0["losses"], ref_losses[:P12_GUARD_STEPS]
    nan = [i for i, x in enumerate(losses) if not math.isfinite(x)]
    off = max(abs(a - b) / abs(b) for a, b in zip(losses, want)
              if math.isfinite(a) and math.isfinite(b))
    if nan != [3, 4, 5] or not off <= P12_GUARD_RTOL:
        raise AssertionError(f"phase 12 (e): losses {losses}, phase 9 "
                             f"(a)'s {want} (rtol {P12_GUARD_RTOL})")
    per_rank = {k: [r["launches"][k] for r in res]
                for k in r0["launches"] if any(r["launches"][k]
                                               for r in res)}
    bad = [k for k in P12_GUARD_USES if min(per_rank.get(k, [0])) < 1]
    evs = read_events(r0["metrics"])
    sat = [e for e in evs if e["event"] == "fp8_sat"]
    if (bad or stream_guard_events(evs) != sink_guard_events(r0["events"])
            or {e["rank"] for e in sat if e["step"] == 3} != {0, 1, 2, 3}
            or sum(e["sat"] for e in sat) != r0["sat"][0]):
        raise AssertionError(
            f"phase 12 (e): kernels {bad} not launched on every rank "
            f"({per_rank}), or rank 0's stream: guard events "
            f"{stream_guard_events(evs)}, step-3 fp8_sat ranks "
            f"{sorted({e['rank'] for e in sat if e['step'] == 3})}, sat "
            f"{sum(e['sat'] for e in sat)} of the world's {r0['sat']}")
    # the same file on one rank: the one-rank model's keys, shapes, dtypes
    cfg = p9_config(model_cfg, tokens)[0]
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    t0 = time.perf_counter()
    _, step = load_checkpoint(r0["path6"], into={
        "params": params, "opt_state": adamw_init(params)})
    _sync(dev)
    one_rank_s = time.perf_counter() - t0
    del params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    wall = r0["wall"]
    steps_ms = sorted((b - a) * 1e3 for a, b in zip(wall, wall[1:]))
    agree = sum(r0["secs"]["agree"])
    gb = r0["bytes6"] / 1e9
    log(f"  (e) {cfg.name} {cfg.n_layers} layers, s1g, fp8 wire, "
        f"{tokens[0]} x {tokens[1]} global tokens on (data=2, model=2), "
        f"{PHASE9_FAULTS}, {P12_GUARD_STEPS} steps: events on every rank "
        f"exactly PHASE9_EVENTS, counters {counters}; history "
        f"{[m[:2] for m in r0['mgr']]}, the rollback onto "
        f"{r0['mgr'][2][2]} past the corrupt step-2 file, retained "
        f"{r0['retained']}; losses "
        + " ".join(f"{x:.4f}" for x in losses) + " (phase 9 (a) "
        + " ".join(f"{x:.4f}" for x in want)
        + f"; finite ones within {off:.2e} relative, limit "
        f"{P12_GUARD_RTOL:g})")
    log(f"  (e) rank 0's stream: the guard events exactly GuardState's; "
        f"{len(sat)} fp8_sat events from ranks "
        f"{sorted({e['rank'] for e in sat})}, at steps "
        f"{sorted({e['step'] for e in sat})}, sat summing to the world's "
        f"{r0['sat'][0]} of {r0['sat'][1]}; launches per rank {per_rank}")
    log(f"  (e) guarded ms/step (rank 0, host clock, snapshots and the "
        f"rollback included): median {steps_ms[len(steps_ms) // 2]:.1f}, "
        f"all {' '.join(f'{x:.1f}' for x in steps_ms)}; the agreement "
        f"all-gathers {1e3 * agree:.2f} ms in {len(r0['secs']['agree'])} "
        f"calls, {100 * agree / (wall[-1] or 1):.3f}% of the run")
    snaps = [st for kind, st in P12_GUARD_HISTORY if kind == "snapshot"]
    for st, (g, t) in zip(snaps, r0["secs"]["save"]):
        log(f"  (e) snapshot {st} (rank 0, {gb:.3f} GB file): gathers "
            f"{g:.3f} s, write {t - g:.3f} s, {gb / t:.2f} GB/s")
    log(f"  (e) restores per rank: the rollback "
        + ", ".join(f"{sum(r['secs']['restore']):.3f}" for r in res)
        + " s (two files read: the corrupt one, then step 0); the step-6 "
        "file into fresh tensors "
        + ", ".join(f"{r['restore6']:.3f}" for r in res)
        + f" s ({gb:.3f} GB, torch.equal to the live shards on every "
        f"rank); on one rank {one_rank_s:.3f} s (the one-rank model's "
        f"keys, shapes and dtypes, step {step})")
    prof = r0["prof"]
    if prof is not None:
        log(f"  (f) --profile across ranks, rank 0 (one clean guarded step, "
            f"sharing the card with three ranks): device busy "
            f"{prof['busy_ms']:.1f} ms (profiled) over {prof['wall_ms']:.1f}"
            f" ms wall (unprofiled): {100 * prof['busy_share']:.1f}% busy; "
            f"{prof['n_kernels']} kernel launches; top ops "
            + ", ".join(f"{o['name']} {o['ms']:.1f} ms"
                        for o in prof["top_ops"]))
    log(f"  (e) and (f) in {max(r['total_s'] for r in res):.1f} s")
    return {"guarded_2x2": per_rank}


#: (d)'s meshes over the 4 ranks: the merged (data=2, model=2), where each
#: data rank's pool is one row of 1 x 2048 tokens, and (data=1, model=4),
#: which runs the first row alone; qwen3's 32 query / 4 kv heads give 16 /
#: 2 and 8 / 1 a rank
P12_BLOCK_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


def p12_block_cfg(model_cfg):
    """(d)'s model: ``model_cfg`` (qwen3-moe-30b-a3b at full width: one
    block, the full vocabulary) cut to one layer, the MoE layer under s2.
    s2 gates a data rank's whole pool on each MP rank, as one rank gates
    its batch, so the pool's capacity drops and its router balance loss
    (a function of the pool) are the one-rank run's (the routed rows are
    checked equal, expert by expert); s1 gates an MP rank's slice of
    the pool."""
    from dataclasses import replace
    return replace(model_cfg, n_layers=1,
                   moe=replace(model_cfg.moe, schedule="s2"))


def _p12_block_refs(model, full, batch, meshes, dims):
    """(d)'s one-rank references on this rank's blocks.  The router's
    balance loss is a pool's (the mean of its per-pool values across
    ranks, JAX's), so each mesh is held to one-rank runs over the same
    pools: row 0 alone for (1, 4); for (2, 2) the mean of the runs over
    row 0 and row 1 (the mean CE of two rows of one label count, and the
    mean of their pools' router losses), their gradients averaged.
    Returns per mesh the parameters' and references' blocks."""
    import torch
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel.sharding import P, local_shard, local_tree
    flat = leaves(full)
    paths = _paths(full)
    counts = (batch["labels"] >= 0).sum(dim=1)
    if int(counts[0]) != int(counts[1]):
        raise AssertionError(f"phase 12 (d): label counts {counts.tolist()}")
    runs = []
    for row in range(2):
        one = {k: v[row:row + 1] for k, v in batch.items()}
        loss, m = model.loss(full, one)
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            hidden = model._backbone(full, one)[0]
        runs.append((float(loss), m["expert_load"].cpu(), hidden,
                     dict(zip(paths, grads))))
        del loss, m, grads
    want = {}
    for name, mesh in meshes.items():
        specs = model.param_specs(full, mesh, dims)
        flat_specs = dict(zip(paths, leaves(specs)))
        use = runs[:1] if mesh.shape["data"] == 1 else runs
        n = len(use)
        want[name] = {
            "params": local_tree({k: _detach(v) for k, v in full.items()},
                                 specs, mesh),
            "loss": sum(r[0] for r in use) / n,
            "load": sum(r[1] for r in use),
            "y": local_shard(torch.cat([r[2] for r in use]),
                             P(dims.batch_axes, None, None), mesh),
            "g": {k: local_shard(sum(r[3][k] for r in use) / n,
                                 flat_specs[k], mesh) for k in paths}}
    return want


def _p12_block_rank(rank, cfg, tokens, serve_ref):
    """(d) on one rank of the 4: the one-rank references
    (``_p12_block_refs``; every rank runs them in turn, the others
    waiting, so the card holds one whole model and its gradients at a
    time; each rank keeps its blocks; rank 0 also serves (g)'s requests
    on one rank with the whole model, into ``serve_ref``), then
    ``Model.loss`` forward and backward on each of ``P12_BLOCK_MESHES``
    with its launches counted.  Returns per mesh the loss, the routed
    rows, the backbone's output and every gradient read against the
    references' blocks (``_p12_err``), the launches and the host seconds;
    and this rank's (2, 2) parameters, for (g)."""
    import torch
    import torch.distributed as dist
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import P, local_shard
    from repro_torch.train.loop import sync_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    dev = _p12_device()
    dims = dims_for(cfg)
    meshes = {k: make_mesh(v, ("data", "model"))
              for k, v in P12_BLOCK_MESHES.items()}
    model = Model(cfg, device=dev)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=tokens[1], global_batch=2)
                        ).tensors(0, dev)
    want = None
    for turn in range(dist.get_world_size()):
        if turn == rank:
            full = model.init(torch.Generator(device=dev).manual_seed(0))
            for t in leaves(full):
                t.requires_grad_(True)
            want = _p12_block_refs(model, full, batch, meshes, dims)
            if rank == 0:
                _p12_serve_reference(full, cfg, dev, serve_ref)
            del full
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    out = {}
    for name, mesh in meshes.items():
        w = want.pop(name)
        params = w["params"]
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        rows = batch if mesh.shape["data"] > 1 else \
            {k: v[:1] for k, v in batch.items()}
        rows = {k: local_shard(v, P(dims.batch_axes, None), mesh)
                for k, v in rows.items()}
        wrappers = reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        loss, m = model.loss(params, rows, mesh=mesh, dims=dims)
        grads = torch.autograd.grad(loss, flat)
        grads = sync_grads(grads, leaves(model.param_specs(params, mesh,
                                                           dims)),
                           mesh, dims, leaves(model.mp_partial(
                               params, mesh, dims, tokens[1])))
        _sync(dev)
        sec = time.perf_counter() - t0
        launches = read_counts(wrappers)
        with torch.no_grad():
            hidden = model._backbone(params, rows, mesh=mesh, dims=dims)[0]
        # expert_load is the pmean of the pools' routed rows; under s2 each
        # MP rank gates its data rank's pool, so load * N is n_mp times the
        # one-rank runs' rows
        tot = m["expert_load"].cpu() * mesh.size
        reads = {"y": _p12_err(hidden, w["y"])}
        reads.update({k: _p12_err(g, w["g"][k])
                      for k, g in zip(_paths(params), grads)})
        out[name] = {"loss": float(loss), "want_loss": w["loss"],
                     "load_ok": torch.equal(
                         tot, w["load"] * mesh.shape["model"]),
                     "reads": reads, "launches": launches, "s": sec}
        if name == "2x2":
            kept = _detach(params)
        del params, flat, grads, hidden, loss, m, w
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["total_s"] = time.perf_counter() - t_all
    return out, kept


#: (g): (d)'s model and weights (qwen3-moe-30b-a3b at full width, one
#: block, the 151936-entry head) served on (2, 2) at the drop-free
#: capacity factor E / k (so a data rank's pool routes as the one-rank
#: pool does): 8 requests of 17-64 tokens, four sharing a 32-token prefix
#: (every prefill, a suffix after a prefix hit included, in the 32-token
#: bucket: one prefill shape for ``measured`` to calibrate, beside the
#: decode pool), 8 new tokens each, max batch 8 (a decode pool of 4 rows a
#: data rank, 2 MP ranks: the real decode path), pages of 16; under
#: ``auto`` (analytic), ``s1d`` forced and ``autosched="measured"``
P12_SERVE_GEN = 8
P12_SERVE_KW = dict(max_batch=8, max_len=128, block_size=16)
P12_SERVE_MODES = (("auto", None, "analytic"), ("s1d", "s1d", "analytic"),
                   ("measured", None, "measured"))
#: the kernels each serving run must launch on every rank (qwen3's norms;
#: every multi-rank MoE body dispatches and combines, s1d's FFN is
#: ``expert_ffn``)
P12_SERVE_USES = {"auto": ("rmsnorm", "moe_dispatch", "moe_combine"),
                  "s1d": ("rmsnorm", "moe_dispatch", "moe_combine",
                          "expert_ffn"),
                  "measured": ("rmsnorm", "moe_dispatch", "moe_combine")}
#: a stream may leave the one-rank one only at a step whose one-rank
#: top-2 logit gap is within phase 12's output tolerance of its top logit
P12_SERVE_RTOL, P12_SERVE_ATOL = 2e-4, 2e-5


def p12_serve_cfg(block_cfg, autosched="analytic"):
    """(g)'s model config: (d)'s under ``schedule="auto"`` at the drop-free
    capacity factor, decided by ``autosched``."""
    from dataclasses import replace
    m = block_cfg.moe
    return replace(block_cfg, moe=replace(
        m, schedule="auto", capacity_factor=m.n_experts / m.top_k,
        autosched=autosched))


def p12_serve_prompts(vocab, seed=12):
    """(g)'s 8 prompts: a 32-token prefix alone and with 17-32 more,
    alternating with prompts of 17-32 tokens."""
    import numpy as np
    rng = np.random.RandomState(seed)
    prefix = [int(t) for t in rng.randint(0, vocab, 32)]
    out = []
    for n_tail, n_own in ((0, 20), (17, 32), (24, 17), (32, 27)):
        out.append(prefix + [int(t) for t in rng.randint(0, vocab, n_tail)])
        out.append([int(t) for t in rng.randint(0, vocab, n_own)])
    return out


def _p12_serve(model, params, prompts, mesh=None, dims=None, schedule=None):
    """Serve ``prompts`` (request i with sampler seed i + 1, greedy), and
    record from the sampler's input each request's first logits row and,
    for every sampled token, its row's top-2 gap and top logit (keyed by
    (rid, position): the sampler's keys name the seed and the position).
    Returns (completions by rid, engine, wall seconds, record)."""
    from repro_torch.serve import Engine, SamplerConfig
    from repro_torch.serve import engine as engine_mod
    sample = engine_mod.sample
    lens = [len(p) for p in prompts]
    rec = {"first": {}, "gap": {}}

    def recording(logits, keys, temps, topks):
        top = logits.float().topk(2, dim=-1).values.cpu()
        for i, (seed, pos) in enumerate(keys.tolist()):
            if seed:                   # 0: an idle row
                rid = seed - 1
                rec["gap"][(rid, pos)] = (float(top[i, 0] - top[i, 1]),
                                          float(top[i, 0]))
                if pos == lens[rid]:
                    rec["first"][rid] = logits[i].float().cpu()
        return sample(logits, keys, temps, topks)

    engine_mod.sample = recording
    try:
        eng = Engine(model, mesh, dims, schedule=schedule, **P12_SERVE_KW)
        for rid, p in enumerate(prompts):
            eng.submit(p, P12_SERVE_GEN, sampler=SamplerConfig(seed=rid + 1),
                       rid=rid)
        _sync(model.device)
        t0 = time.perf_counter()
        done = eng.run(params)
        _sync(model.device)
        wall = time.perf_counter() - t0
    finally:
        engine_mod.sample = sample
    return {c.rid: c for c in done}, eng, wall, rec


def _p12_serve_reference(full, block_cfg, dev, path):
    """(g)'s one-rank reference, run by rank 0 with the whole model in its
    turn of (d): the streams, first logits and gaps, and the prefill
    pools' routed rows per expert ((i) replicates the two most routed),
    saved to ``path``."""
    import torch
    from repro_torch.models import Model
    from repro_torch.models import blocks
    model = Model(p12_serve_cfg(block_cfg), device=dev)
    apply_moe, prefill = blocks.apply_moe, []

    def recording(x, params, **kw):
        y, aux = apply_moe(x, params, **kw)
        if not kw.get("infer"):
            prefill.append(aux["expert_load"].cpu())
        return y, aux

    blocks.apply_moe = recording
    try:
        done, _, wall, rec = _p12_serve(
            model, _detach(full), p12_serve_prompts(block_cfg.vocab_size))
    finally:
        blocks.apply_moe = apply_moe
    torch.save({"tokens": {r: c.tokens for r, c in done.items()},
                "first": rec["first"], "gap": rec["gap"], "wall": wall,
                "prefill_load": sum(prefill)}, path)


def _p12_read_serve(done, eng, rec, ref, prompts):
    """One mesh serving run read against rank 0's one-rank run ``ref``:
    every request complete, every page back, each request's first logits
    (rtol 2e-4, atol 2e-5), and where a stream leaves the one-rank one,
    whether that step's one-rank top-2 gap is within the tolerance (a
    tie) or not (off); the engine's counts and latencies."""
    from repro_torch.serve import latency_stats
    complete = (len(done) == len(prompts) and all(
        c.status == "ok" and len(c.tokens) == P12_SERVE_GEN
        for c in done.values()))
    first = {rid: _p12_err(rec["first"][rid], ref["first"][rid])
             for rid in range(len(prompts))}
    ties, off = [], []
    for rid, c in done.items():
        want = ref["tokens"][rid]
        j = next((j for j, (a, b) in enumerate(zip(c.tokens, want))
                  if a != b), None)
        if j is None:
            continue
        gap, top = ref["gap"][(rid, len(prompts[rid]) + j)]
        tol = P12_SERVE_ATOL + P12_SERVE_RTOL * abs(top)
        (ties if gap <= tol else off).append((rid, j, gap, tol))
    return {"complete": complete, "stats": dict(eng.stats),
            "live": eng.pool.n_live,
            "first_ok": all(r["elem_ok"] for r in first.values()),
            "first_err": max(r["err"] for r in first.values()),
            "ties": ties, "off": off,
            "latency": latency_stats(done.values())}


def _p12_serve_rank(rank, block_cfg, params, ref_path):
    """(g) on one rank of the (2, 2) mesh: ``P12_SERVE_MODES``' runs with
    this rank's shards of (d)'s weights, each read here against rank 0's
    one-rank run: every request's status and budget, the engine's counts,
    the plan agreed once a tick, each request's first logits (rtol 2e-4,
    atol 2e-5), and where a stream leaves the one-rank one, that step's
    one-rank top-2 gap.  Returns the readings, latencies, launches and
    each collective's host seconds per run."""
    import torch
    from repro_torch.core import autosched
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import make_mesh
    t_all = time.perf_counter()
    dev = _p12_device()
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(block_cfg)
    prompts = p12_serve_prompts(block_cfg.vocab_size)
    ref = torch.load(ref_path, weights_only=False)
    agreed, agree = [], comm.agree
    measure = autosched.measure_candidates

    def counting(values, grp, what, device="cpu"):
        if what.startswith("the serving plan"):
            agreed.append(values[0])
        return agree(values, grp, what, device)

    comm.agree = counting
    # ``measured`` times each candidate once after its warm-up call, as (h)
    # does: the checks read the pick's tokens, not the medians' spread
    autosched.measure_candidates = functools.partial(measure, iters=1)
    out = {"ref_wall": ref["wall"]}
    try:
        for mode, schedule, how in P12_SERVE_MODES:
            model = Model(p12_serve_cfg(block_cfg, how), device=dev)
            agreed.clear()
            wrappers = reset_counts()
            comm.timing(True)
            done, eng, wall, rec = _p12_serve(model, params, prompts, mesh,
                                              dims, schedule)
            coll = comm.times()
            comm.timing(False)
            launches = read_counts(wrappers)
            out[mode] = _p12_read_serve(done, eng, rec, ref, prompts)
            out[mode].update(
                agreed=agreed == list(range(1, eng._tick + 1)), wall=wall,
                launches=launches, comm=coll)
    finally:
        comm.agree = agree
        autosched.measure_candidates = measure
    out["summary"] = autosched.cache_summary()
    out["s"] = time.perf_counter() - t_all
    return out


def _paths(tree, pre=""):
    """The dotted paths of a nested dict's leaves, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, pre + k + ".")]
    return [pre[:-1]]


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    return tree.detach()


def _p12_train_cfg(model_cfg):
    from dataclasses import replace
    return replace(model_cfg, n_layers=P12_TRAIN_LAYERS,
                   moe=_p12_cfg(model_cfg, "auto"))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _p12_train_rank(rank, scheds, steps, model_cfg, tokens):
    """(b) and (c) on one rank of the merged (2, 2) mesh: gpt2-moe
    (``P12_TRAIN_LAYERS`` layers, 8 x 1024 global) for ``steps`` steps
    under each schedule, the
    first step taken twice from one state (``torch.equal`` parameters and
    moments, checked here); per step the loss, gradient norm, host ms and
    each collective's host seconds."""
    import time

    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.train import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _p12_device()
    cfg = _p12_train_cfg(model_cfg)
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tokens[1], global_batch=tokens[0]))
    out = {}
    for sched in scheds:
        model = Model(cfg, device=dev)
        tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=steps), schedule=sched,
                     mesh=mesh, dims=dims)
        params, opt = tr.setup(torch.Generator(device=dev).manual_seed(0))
        snap = [t.clone() for t in _state_tensors(params, opt)]
        batch = tr.batch(data, 0)
        wrappers = reset_counts()
        params, opt, m0 = tr.train_step(params, opt, batch)
        first = [t.clone() for t in _state_tensors(params, opt)]
        for t, v in zip(_state_tensors(params, opt), snap):
            with torch.no_grad():
                t.copy_(v)
        del snap
        rows = []
        for step in range(steps):
            batch = tr.batch(data, step)
            _sync(dev)
            comm.timing(True)
            t0 = time.perf_counter()
            params, opt, m = tr.train_step(params, opt, batch)
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]), "ms": ms,
                         "comm": comm.times()})
            comm.timing(False)
            if step == 0:
                same = [torch.equal(a, b) for a, b in
                        zip(first, _state_tensors(params, opt))]
                if not all(same):
                    raise AssertionError(
                        f"phase 12 (b) {sched} rank {rank}: the first step "
                        f"taken twice differs in {same.count(False)} of "
                        f"{len(same)} parameter and moment tensors")
                del first
        out[sched] = {"rows": rows, "launches": read_counts(wrappers)}
        del params, opt, tr, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _p12_one_rank_train(dev, steps, model_cfg, tokens):
    """(b)'s reference: the same model, seed and batches on one rank."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer
    cfg = _p12_train_cfg(model_cfg)
    model = Model(cfg, device=dev)
    tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=2,
                                    total_steps=steps))
    params, opt = tr.setup(torch.Generator(device=dev).manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=tokens[1], global_batch=tokens[0]))
    rows = []
    for step in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, m = tr.train_step(params, opt, data.tensors(step, dev))
        _sync(dev)
        rows.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "ms": (time.perf_counter() - t0) * 1e3})
    del params, opt, tr, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rows


def _p12_report(label, n, res, paths):
    """(a)'s checks and log lines for one mesh's per-rank results ``res``;
    returns the names of the failed cases (every case is logged first)."""
    failed = []
    for i, case in enumerate(res[0]):
        name = case["name"]
        cases = [rk[i] for rk in res]
        uses = P12_USES.get(name.split("-")[0], P12_DEFAULT_USES)
        per_rank = {k: [c["launches"][k] for c in cases]
                    for k in case["launches"]
                    if any(c["launches"][k] for c in cases)}
        bad = [k for k in uses if min(per_rank.get(k, [0])) < 1]
        if bad:
            raise AssertionError(f"phase 12 (a) {label} {name}: {bad} not "
                                 f"launched on every rank: {per_rank}")
        ok = all(c["load_ok"] and all(
            _p12_ok(r, c["wire"], k == "y") for k, r in c["reads"].items())
            for c in cases)
        worst = {k: max((c["reads"][k] for c in cases),
                        key=lambda r: r["err"] / r["scale"])
                 for k in case["reads"]}
        wire = case["wire"] != "f32"
        log(f"  (a) {label} {name}: " + "; ".join(
            f"{k} max_abs_err {r['err']:.3e}"
            + (f" ({r['err'] / r['scale']:.3e} of max(1, max|want|), share "
               f"{r['share']:.4f} above 2e-4 of it, rel {r['rel']:.3e})"
               if wire else "")
            for k, r in worst.items())
            + (f"; expert_load exact (x{case['mult']:g} / {n})"
               if case["mult"] else "")
            + f"; launches per rank {per_rank}"
            + f"; host ms {max(c['ms'] for c in cases):.1f} (collectives "
            + ", ".join(f"{k} {1e3 * v[2]:.1f}"
                        for k, v in sorted(case["comm"].items())) + ")"
            + ("" if ok else " FAILED"))
        if not ok:
            failed.append(f"{label} {name}")
        if "volumes" in case:
            # the forward's collectives, by kind and group, on every rank
            bad = [r for r, c in enumerate(cases)
                   if c["volumes"] != c["closed_form"]]
            if bad:
                raise AssertionError(
                    f"phase 12 (a) {label} {name}: ranks {bad}' forward "
                    f"collectives {cases[bad[0]]['volumes']}, the closed "
                    f"form {case['closed_form']}")
            log(f"      forward collectives on every rank = the closed form"
                f" (kind: {{group: (count, bytes)}}): {case['volumes']}")
        paths[f"layer_{label}_{name}"] = per_rank
    return failed


#: (k): the KV-cache serve path on (2, 2), mistral-nemo-12b at full width
#: cut to 4 layers (``p12_kv_cfg``), Megatron-sharded over model: (name,
#: prompt lengths, tokens generated after the prefill); W is the longest
#: prompt plus those, and with ``seq_shard`` B=1 splits W over data x
#: model (the batch axes idle), B=2 over model (the batch over data)
#: (16 tokens each: gloo's host path takes ~150 ms a W-sharded decode
#: step, and the spawn's seconds go to (l) too)
P12_KV_CASES = (("b1", (16384,), 16), ("b2", (2048, 1536), 16))
#: (k)'s logits against the f64 witness (``logits_f64``; stated before its
#: first run): the one-rank run's ||d|| / ||witness|| at most
#: ``P12_KV_WITNESS_REL`` (else the witness is wrong), and each rank's
#: logits on each layout no further from the witness than
#: ``P12_KV_EXACT_RATIO`` = (rel, max |d|) times the one-rank run's on the
#: same rows: the sharded runs are as exact as one rank is, whatever f32's
#: own rounding at 5120 wide
P12_KV_WITNESS_REL = 2e-5
P12_KV_EXACT_RATIO = (2.0, 3.0)


def p12_kv_cfg():
    from dataclasses import replace

    from repro_torch.configs import get_config
    return replace(get_config("mistral-nemo-12b"), n_layers=N_LAYERS)


def _p12_kv_prompts(vocab, lens):
    import numpy as np
    import torch
    rng = np.random.RandomState(12)
    toks = np.zeros((len(lens), max(lens)), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, vocab, n)
    return torch.from_numpy(toks), torch.tensor(lens)


class _LogitsTap:
    """``model`` with each ``decode_step``'s logits kept (``seen``): the
    greedy loop of ``make_serve_step`` over it is read against a
    reference without a second loop."""

    def __init__(self, model):
        self.model, self.seen = model, []

    def decode_step(self, *args, **kw):
        logits, cache = self.model.decode_step(*args, **kw)
        self.seen.append(logits[:, 0])
        return logits, cache


def kv_run(model, params, toks, lens, gen, W, batch, **mesh_kw):
    """``prefill_step`` then ``gen`` greedy ``make_serve_step`` steps
    (each row at its own position) on a fresh cache of ``batch`` rows (on
    a mesh ``toks`` and ``lens`` are this rank's) and W slots; returns the
    cache, the tokens (B, gen + 1), every step's logits (B, gen + 1, V) on
    the host, the prefill's and the decode loop's seconds, and on a mesh
    the decode loop's collectives (``comm.timing``)."""
    import torch
    from repro_torch.parallel import comm
    from repro_torch.train import make_serve_step
    dev = model.device
    tap = _LogitsTap(model)
    serve_step = make_serve_step(tap, **mesh_kw)
    cache = model.init_cache(batch, W, **mesh_kw)
    toks, lens = toks.to(dev), lens.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill_step(params, cache, {"tokens": toks},
                                           lengths=lens, **mesh_kw)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        stream = [tok]
        comm.timing(bool(mesh_kw))
        t0 = time.perf_counter()
        for t in range(gen):
            tok, cache = serve_step(params, cache, {"tokens": tok,
                                                    "step": lens + t})
            stream.append(tok)
        _sync(dev)
    t_decode = time.perf_counter() - t0
    coll = comm.times()
    comm.timing(False)
    return (cache, torch.cat(stream, 1).long().cpu(),
            torch.stack([logits, *tap.seen], 1).cpu(), t_prefill, t_decode,
            coll)


def teacher_forced(toks, lens, stream):
    """(tokens, positions): each row's prompt and then its ``stream``'s
    tokens but the last, (B, max(lens) + gen), and the (B, gen + 1)
    positions whose logits predict the stream's tokens."""
    import torch
    B, L = toks.shape
    gen = stream.shape[1] - 1
    full = torch.zeros((B, L + gen), dtype=torch.long)
    full[:, :L] = toks
    rows = torch.arange(B)
    for t in range(gen):
        full[rows, lens + t] = stream[:, t]
    return full, lens[:, None] + torch.arange(gen + 1)[None] - 1


def logits_f64(model, params, tokens, pos):
    """The f64 witness of a dense rope model's logits at ``pos`` (B, n)
    of ``tokens`` (B, L), both on the card: every product, norm, softmax
    and sum in f64 from the f32 parameters; only the rope table is the
    port's (f32 angles, as ``apply_rope`` makes them).  Attention one
    block of 1024 queries at a time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.layers import rope_freqs
    from repro_torch.models.model import layer_views
    cfg = model.cfg
    if (not cfg.use_rope or cfg.norm_type != "rmsnorm" or cfg.qkv_bias
            or cfg.parallel_block or cfg.attn_window or cfg.attn_chunk
            or cfg.ffn_act != "silu" or cfg.tie_embeddings
            or any(kind != "dense" for kind, _ in model.runs)):
        raise ValueError(f"logits_f64: {cfg.name} is not a dense, untied, "
                         "rope + rmsnorm + SwiGLU model")
    f8, dev = torch.float64, tokens.device
    B, L = tokens.shape
    H, K, hd, eps = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.norm_eps
    ang = torch.arange(L, device=dev).float()[:, None] * rope_freqs(
        hd, cfg.rope_theta, dev)
    cos, sin = (f(ang).to(f8)[:, None, :] for f in (torch.cos, torch.sin))

    def rope(x):
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def norm(x, p):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * p["scale"].to(f8)

    x = params["embed"]["table"][tokens].to(f8)
    for r, (_, n) in enumerate(model.runs):
        for p in layer_views(params[f"run{r}"], n):
            a, f = ({k: t.to(f8) for k, t in p[m].items()}
                    for m in ("attn", "ffn"))
            h = norm(x, p["norm1"])
            q = rope((h @ a["wq"]).reshape(B, L, H, hd))
            k = rope((h @ a["wk"]).reshape(B, L, K, hd))
            k = k.repeat_interleave(H // K, 2)
            v = (h @ a["wv"]).reshape(B, L, K, hd).repeat_interleave(
                H // K, 2)
            o = torch.empty_like(q)
            for i in range(0, L, 1024):
                j = min(L, i + 1024)
                sc = torch.einsum("bqhd,bkhd->bhqk", q[:, i:j], k[:, :j])
                qp = torch.arange(i, j, device=dev)[:, None]
                sc = sc.masked_fill(torch.arange(j, device=dev)[None] > qp,
                                    -torch.inf) * hd ** -0.5
                o[:, i:j] = torch.einsum("bhqk,bkhd->bqhd",
                                         sc.softmax(-1), v[:, :j])
            x = x + o.reshape(B, L, H * hd) @ a["wo"]
            h = norm(x, p["norm2"])
            x = x + (F.silu(h @ f["w_gate"]) * (h @ f["w_in"])) @ f["w_out"]
            del a, f, h, q, k, v, o
    x = norm(x, params["final_norm"])
    x = x[torch.arange(B, device=dev)[:, None], pos]          # (B, n, D)
    return (x @ params["lm_head"]["w"].to(f8)) * cfg.logit_scale


def _p12_kv_reference(dev, cfg, path):
    """(k)'s one-rank reference, made before the spawn with the whole
    model: ``P12_KV_CASES`` and each case's tokens and logits, and the
    f64 witness of those logits (``logits_f64`` over the teacher-forced
    tokens), saved to ``path``.  Fails unless the one-rank logits are
    within ``P12_KV_WITNESS_REL`` of the witness (||d|| / ||witness||):
    a witness that disagrees more holds nothing."""
    import torch
    from repro_torch.models import Model
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    ref = {"cases": P12_KV_CASES}
    for name, lens, gen in P12_KV_CASES:
        toks, lens_t = _p12_kv_prompts(cfg.vocab_size, lens)
        cache, stream, logits, tp, td, _ = kv_run(
            model, params, toks, lens_t, gen, max(lens) + gen, len(lens))
        del cache
        full, pos = teacher_forced(toks, lens_t, stream)
        with torch.no_grad():
            exact = logits_f64(model, params, full.to(dev),
                               pos.to(dev)).float().cpu()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        one = _p12_err(logits, exact)
        if not one["rel"] <= P12_KV_WITNESS_REL:
            raise AssertionError(f"phase 12 (k) {name}: one rank vs the "
                                 f"f64 witness {one}")
        log(f"  (k) {name}: one rank's logits vs the f64 witness max |d| "
            f"{one['err']:.3e} (scale {one['scale']:.3g}), rel "
            f"{one['rel']:.3e}; 2e-5 + 2e-4 |w| "
            f"{'held' if one['elem_ok'] else 'not held'}")
        ref[name] = {"tokens": stream, "logits": logits, "exact": exact,
                     "prefill_s": tp, "decode_s": td}
    torch.save(ref, path)
    del params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _p12_kv_rank(rank, cfg, ref_path):
    """(k) on one rank of the (2, 2) mesh: its Megatron shards of the
    model (the whole model made in turn, one rank at a time, as (d)
    does), then each case of the reference with ``seq_shard`` False and
    True: the tokens
    and logits read against the one-rank reference and the f64 witness
    (``_p12_err``), the
    cache's K/V bytes, the decode loop's collectives per kind
    (``comm.timing``) beside one step's on a fresh cache of 2W, launches
    and seconds."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import dims_for
    from repro_torch.models import Model
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import P, local_shard, local_tree
    from repro_torch.train import cache_specs
    t_all = time.perf_counter()
    dev = _p12_device()
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = dims_for(cfg)
    model = Model(cfg, device=dev)
    params = None
    for turn in range(dist.get_world_size()):
        if turn == rank:
            full = model.init(torch.Generator(device=dev).manual_seed(0))
            params = local_tree(full, model.param_specs(full, mesh, dims),
                                mesh)
            del full
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    ref = torch.load(ref_path, weights_only=False)
    out = {"init_s": time.perf_counter() - t_all, "cases": ref["cases"]}
    for name, lens, gen in ref["cases"]:
        toks, lens_t = _p12_kv_prompts(cfg.vocab_size, lens)
        B, W = len(lens), max(lens) + gen
        want = ref[name]
        for seq_shard in (False, True):
            kw = dict(mesh=mesh, dims=dims, specs=cache_specs(
                model, mesh, dims, B, W, seq_shard=seq_shard))
            rows = P(kw["specs"]["run0"]["attn"]["pos"][1])
            wrappers = reset_counts()
            cache, stream, logits, tp, td, coll = kv_run(
                model, params, local_shard(toks, rows, mesh),
                local_shard(lens_t, rows, mesh), gen, W, B, **kw)
            launches = read_counts(wrappers)
            kv = [t for t in leaves(cache) if t.dim() == 5]
            kv_bytes = sum(t.numel() * t.element_size() for t in kv)
            del cache
            # one decode step at 2W: the same collectives, the same bytes
            kw2 = dict(kw, specs=cache_specs(model, mesh, dims, B, 2 * W,
                                             seq_shard=seq_shard))
            cache = model.init_cache(B, 2 * W, **kw2)
            comm.timing(True)
            with torch.no_grad():
                model.decode_step(params, cache, {
                    "tokens": stream[:, :1].to(dev), "step": 0}, **kw2)
            coll2 = comm.times()
            comm.timing(False)
            del cache
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            if not seq_shard:
                heads = logits
            mine, exact = (local_shard(want[k], rows, mesh)
                           for k in ("logits", "exact"))
            out[(name, seq_shard)] = {
                "spec": tuple(kw["specs"]["run0"]["attn"]["k"]),
                "tokens_ok": torch.equal(stream, local_shard(
                    want["tokens"], rows, mesh)),
                "logits": _p12_err(logits, mine),
                "vs_exact": _p12_err(logits, exact),
                "one_vs_exact": _p12_err(mine, exact),
                "vs_heads": _p12_err(logits, heads),
                "kv_bytes": kv_bytes, "comm": coll, "comm_2w": coll2,
                "launches": launches, "on_card": dev.type == "cuda",
                "prefill_s": tp, "decode_s": td,
                "gen": gen, "ref_s": (want["prefill_s"], want["decode_s"])}
    out["s"] = time.perf_counter() - t_all
    return out


def _p12_kv_report(res, cfg):
    """(k)'s checks and log lines from each rank's ``_p12_kv_rank``:
    tokens equal to the one-rank reference on every rank and layout,
    logits as close to the f64 witness as the one-rank run's
    (``P12_KV_EXACT_RATIO``; phase 12's output tolerance against the
    one-rank run is logged), the split-W logits within that tolerance of
    the same rank's whole-W run, the W-sharded K/V bytes
    1/nw of the whole cache's, a decode step's bytes per collective kind
    the same at W and 2W.  Returns each run's per-rank launches."""
    acfg_bytes = 4 * cfg.n_kv_heads * cfg.hd * 2 * cfg.n_layers
    paths, failed = {}, []
    for name, lens, gen in res[0]["cases"]:
        B, W = len(lens), max(lens) + gen
        for seq_shard in (False, True):
            rs = [r[(name, seq_shard)] for r in res]
            label = f"{name} {'W-sharded' if seq_shard else 'heads'}"
            spec = rs[0]["spec"]
            nw = 2 ** len(spec[2] or ())           # each axis of (2, 2)
            # every kv head of all W for this rank's rows (JAX's spec)
            whole = acfg_bytes * W * (B // 2 if spec[1] else B)
            per_step = {}
            for rk, r in enumerate(rs):
                steps = {k: (c // r["gen"], b // r["gen"])
                         for k, (c, b, _) in r["comm"].items()
                         if k != "in_flight"}
                at_2w = {k: (c, b) for k, (c, b, _) in r["comm_2w"].items()
                         if k != "in_flight"}
                bad = []
                if not r["tokens_ok"]:
                    bad.append("tokens")
                ex, one = r["vs_exact"], r["one_vs_exact"]
                if not (ex["rel"] <= P12_KV_EXACT_RATIO[0] * one["rel"]
                        and ex["err"] <= P12_KV_EXACT_RATIO[1] * one["err"]):
                    bad.append(f"logits vs the f64 witness {ex}, one rank's "
                               f"{one}")
                if not r["vs_heads"]["elem_ok"]:
                    bad.append(f"logits vs W whole {r['vs_heads']}")
                if steps != at_2w:
                    bad.append(f"bytes a step {steps} at W, {at_2w} at 2W")
                if seq_shard and spec[2] and r["kv_bytes"] * nw != whole:
                    bad.append(f"K/V {r['kv_bytes']} bytes, whole {whole}")
                if r["on_card"] and (
                        r["launches"]["flash_attention"] != cfg.n_layers
                        or r["launches"]["rmsnorm"] != (gen + 1) * (
                            2 * cfg.n_layers + 1)):
                    bad.append(f"launches {r['launches']}")
                if bad:
                    failed.append(f"{label} rank {rk}: {'; '.join(bad)}")
                per_step[rk] = {k: (b, r["comm"][k][2] / r["gen"] * 1e3)
                                for k, (_, b) in steps.items()}
            r0 = rs[0]
            log(f"  (k) {label} (B={B}, W={W}, spec {spec}): prefill "
                f"{max(r['prefill_s'] for r in rs):.2f} s, {gen} steps "
                f"{max(r['decode_s'] for r in rs):.2f} s ("
                f"{B * gen / max(r['decode_s'] for r in rs):.1f} tok/s; one "
                f"rank {r0['ref_s'][0]:.2f} s / {B * gen / r0['ref_s'][1]:.1f}"
                f" tok/s); tokens = one rank's on "
                f"{sum(r['tokens_ok'] for r in rs)}/4 ranks; logits vs the "
                f"f64 witness max |d| "
                f"{max(r['vs_exact']['err'] for r in rs):.3e}, rel "
                f"{max(r['vs_exact']['rel'] for r in rs):.3e} (one rank on "
                f"the same rows: max |d| "
                f"{max(r['one_vs_exact']['err'] for r in rs):.3e}, rel "
                f"{max(r['one_vs_exact']['rel'] for r in rs):.3e}); vs one "
                f"rank max |d| {max(r['logits']['err'] for r in rs):.3e} "
                f"(scale {r0['logits']['scale']:.3g}, rel "
                f"{max(r['logits']['rel'] for r in rs):.2e}; 2e-5 + 2e-4 |w| "
                f"on {sum(r['logits']['elem_ok'] for r in rs)}/4); vs W whole "
                f"max |d| {max(r['vs_heads']['err'] for r in rs):.3e} "
                f"(2e-5 + 2e-4 |w| on "
                f"{sum(r['vs_heads']['elem_ok'] for r in rs)}/4); K/V "
                f"bytes a rank {r0['kv_bytes'] / 1e6:.1f} MB; every head and "
                f"slot of its rows {whole / 1e6:.1f} MB")
            for rk in range(len(rs)):
                log(f"    rank {rk} a decode step: " + ", ".join(
                    f"{k} {b} B {ms:.2f} ms"
                    for k, (b, ms) in sorted(per_step[rk].items()))
                    + f" (2W: the same bytes); launches "
                    f"{({k: v for k, v in rs[rk]['launches'].items() if v})}")
            tag = "seq" if seq_shard else "heads"
            paths[f"kvcache_2x2_{name}_{tag}"] = {
                k: [r["launches"][k] for r in rs]
                for k in rs[0]["launches"]
                if any(r["launches"][k] for r in rs)}
    if failed:
        raise AssertionError("phase 12 (k): " + " | ".join(failed))
    log(f"  (k) in {max(r['s'] for r in res):.1f} s a rank (their shards "
        f"made in turn: {max(r['init_s'] for r in res):.1f} s)")
    return paths


# --- phase 12 (l): the recurrent kinds across ranks ------------------------

#: (l): (arch, path tag, layers, global (batch, seq) trained, decode rows)
#: at full width cut in depth, on the merged (2, 2) mesh: hymba's 4
#: layers (its 25 / 5 heads do not divide over 2: the gathered-heads
#: layout, every head on every rank; the Mamba cell on half of d_inner),
#: xlstm's one ``[mlstm x 7, slstm]`` group (the mLSTM cell on 2 of its 4
#: heads a rank; the sLSTM cell whole on every rank, its host-bound loop on
#: each).  One row a data rank trains (1 x 2048 and 1 x 512), 8 decode.
P12_RZOO = (("hymba-1.5b", "hymba", 4, (2, 2048), 16),
            ("xlstm-350m", "xlstm", 8, (2, 512), 16))
#: teacher-forced decode steps from an empty cache
P12_RZOO_STEPS = 16


def p12_rzoo_cfg(arch, layers):
    """(l)'s config: ``arch`` at full width cut to ``layers``."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    return replace(get_config(arch), n_layers=layers)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _tree_leaves(tree):
    """A cache's (or its specs') leaves: dicts and a state's tuple walked,
    a ``PartitionSpec`` (a tuple subclass) kept whole."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if type(tree) is tuple:
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def _p12_rzoo_inputs(cfg, dec_rows, B, L, dev):
    """(l)'s batch (``SyntheticLM`` batch 0, B x L) and decode tokens
    (``dec_rows`` x ``P12_RZOO_STEPS``), the same in the reference and on
    every rank."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticLM
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=L,
                                   global_batch=B)).tensors(0, dev)
    toks = torch.from_numpy(np.random.RandomState(12).randint(
        0, cfg.vocab_size, (dec_rows, P12_RZOO_STEPS))).to(dev)
    return batch, toks


@contextlib.contextmanager
def _catching_grads(seen):
    """``make_train_step``'s gradients, caught in ``seen`` where the step
    hands them to AdamW (the tensors themselves: AdamW reads them and
    writes none)."""
    from repro_torch.train import loop
    adamw = loop.adamw_update

    def catching(params, grads, *a, **kw):
        seen[:] = [g.detach() for g in grads]
        return adamw(params, grads, *a, **kw)
    loop.adamw_update = catching
    try:
        yield seen
    finally:
        loop.adamw_update = adamw


def _save_behind(obj, path, writers):
    """``torch.save(obj, path)`` on a thread appended to ``writers``
    (joined by the caller), through ``path + ".part"`` renamed when
    whole, so that (l)'s and (m)'s references reach the disk while the
    spawn starts and runs its earlier sub-phases; a failure is kept on
    the thread (``.error``) for the caller to raise."""
    import torch

    def write():
        try:
            t0 = time.perf_counter()
            torch.save(obj, path + ".part")
            os.replace(path + ".part", path)
            thread.seconds = time.perf_counter() - t0
        except BaseException as e:      # re-raised by the caller
            thread.error = e
    thread = threading.Thread(target=write)
    thread.error, thread.path = None, path
    thread.start()
    writers.append(thread)


def _load_when_written(path, timeout=600.0):
    """``torch.load(path)`` memory-mapped, once ``_save_behind`` has
    renamed it into place."""
    import torch
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was never written")
        time.sleep(0.2)
    return torch.load(path, mmap=True, weights_only=False)


def _p12_rzoo_reference(dev, path, writers):
    """(l)'s one-rank runs on the card, made before the spawn (each model
    freed before the next): per config the whole model from seed 0,
    ``P12_RZOO_STEPS`` teacher-forced ``decode_step`` logits and the
    states after them, then one ``make_train_step`` step's loss and the
    gradients it hands AdamW, with each leaf's largest entry; written to
    ``path`` + ``_<tag>.pt`` behind (``_save_behind``: the ranks read
    their shards of it, memory-mapped, and make their parameters from the
    seed)."""
    import torch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import loop
    for arch, tag, layers, (B, L), dec_rows in P12_RZOO:
        t0 = time.perf_counter()
        cfg = p12_rzoo_cfg(arch, layers)
        model = Model(cfg, device=dev)
        batch, toks = _p12_rzoo_inputs(cfg, dec_rows, B, L, dev)
        full = model.init(torch.Generator(device=dev).manual_seed(0))
        cache = model.init_cache(dec_rows, P12_RZOO_STEPS)
        logits = []
        with torch.no_grad():
            for t in range(P12_RZOO_STEPS):
                lg, cache = model.decode_step(full, cache, {
                    "tokens": toks[:, t:t + 1], "step": t})
                logits.append(lg)
        states = [c.cpu() for c in _tree_leaves(cache)]
        ref = {"logits": torch.stack(logits).cpu(), "cache": states,
               "cache_scale": [float(c.float().abs().max()) for c in states]}
        del cache, logits
        seen = []
        with _catching_grads(seen):
            _, _, m = loop.make_train_step(model, AdamWConfig())(
                full, adamw_init(full), batch)
        ref["loss"] = float(m["loss"])
        ref["g_scale"] = [float(g.abs().max()) for g in seen]
        ref["g"] = [g.cpu() for g in seen]
        del full, m, seen
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _save_behind(ref, f"{path}_{tag}.pt", writers)
        log(f"  (l) {arch}'s one-rank reference in "
            f"{time.perf_counter() - t0:.1f} s (written behind)")
        del ref


def _p12_rzoo_rank(rank, path):
    """(l) on one rank of the (2, 2) mesh, for each of ``P12_RZOO``: its
    shards of the parameters from seed 0 (the whole model made in turn,
    one rank at a time) and of the one-rank reference (``path``,
    ``_p12_rzoo_reference``), then the decode steps (the states in
    ``cache_specs``' layout) and one ``make_train_step`` step, the
    gradients caught where the step hands them to AdamW.  Returns per
    config the readings, the launches, host seconds, each collective's
    bytes a step and the peak memory."""
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import (P, local_shard, local_tree,
                                               mentioned)
    from repro_torch.train import cache_specs, loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _p12_device()
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = ParallelDims(dp=("data",), mp=("model",))
    mp = mesh.group(("model",))
    rows_of = P(dims.batch_axes, None)
    out = {}
    for arch, tag, layers, (B, L), dec_rows in P12_RZOO:
        t0 = time.perf_counter()
        cfg = p12_rzoo_cfg(arch, layers)
        model = Model(cfg, device=dev)
        batch, toks = _p12_rzoo_inputs(cfg, dec_rows, B, L, dev)
        params = None
        for turn in range(dist.get_world_size()):
            if turn == rank:
                full = model.init(torch.Generator(device=dev).manual_seed(0))
                params = _clone(local_tree(full, model.param_specs(
                    full, mesh, dims), mesh))
                del full
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        want = _load_when_written(f"{path}_{tag}.pt")
        rec = {"shards_s": time.perf_counter() - t0}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # decode: this rank's rows, its shard of every state
        cspecs = cache_specs(model, mesh, dims, dec_rows, P12_RZOO_STEPS)
        cache = model.init_cache(dec_rows, P12_RZOO_STEPS, mesh=mesh,
                                 dims=dims, specs=cspecs)
        mine = local_shard(toks, rows_of, mesh)
        wrappers = reset_counts()
        logits = []
        with torch.no_grad():
            for t in range(P12_RZOO_STEPS):
                if t == P12_RZOO_STEPS - 1:
                    _sync(dev)
                    rec["decode_ms"] = (time.perf_counter() - t0) * 1e3 / t
                    comm.timing(True)
                elif t == 0:
                    _sync(dev)
                    t0 = time.perf_counter()
                lg, cache = model.decode_step(params, cache, {
                    "tokens": mine[:, t:t + 1], "step": t}, mesh=mesh,
                    dims=dims, specs=cspecs)
                logits.append(lg)
        rec["decode_bytes"] = comm.bytes_out()
        comm.timing(False)
        rec["decode_launches"] = read_counts(wrappers)
        rec["logits"] = _p12_err(torch.stack(logits), local_shard(
            want["logits"], P(None, dims.batch_axes, None, None),
            mesh).to(dev))
        states = []
        for got, w, s, sp in zip(_tree_leaves(cache), want["cache"],
                                 want["cache_scale"],
                                 _tree_leaves(cspecs)):
            w = local_shard(w, sp, mesh).to(dev)
            if got.dtype == torch.int32:
                states.append(torch.equal(got, w))
            else:
                states.append(float((got - w).abs().max())
                              <= 2e-4 * max(s, 1e-30))
        rec["states_ok"] = all(states)
        rec["state_bytes"] = sum(t.numel() * t.element_size()
                                 for t in _tree_leaves(cache))
        rec["state_shape"] = [tuple(t.shape) for t in
                              _tree_leaves(cache)][:3]
        del cache, logits
        # training: one make_train_step step from the same shards
        rows = {k: local_shard(v, rows_of, mesh) for k, v in batch.items()}
        opt = adamw_init(params)
        specs = leaves(model.param_specs(params, mesh, dims))
        names = _paths(params)
        seen = []
        wrappers = reset_counts()
        comm.timing(True)
        _sync(dev)
        t0 = time.perf_counter()
        with _catching_grads(seen):
            _, _, m = loop.make_train_step(model, AdamWConfig(), None, mesh,
                                           dims)(params, opt, rows)
        _sync(dev)
        rec["train_s"] = time.perf_counter() - t0
        rec["train_bytes"] = comm.bytes_out()
        comm.timing(False)
        rec["train_launches"] = read_counts(wrappers)
        rec["loss"], rec["want_loss"] = float(m["loss"]), want["loss"]
        worst, digests = (0.0, ""), []
        for name, g, w, sc, sp in zip(names, seen, want["g"],
                                      want["g_scale"], specs):
            w = local_shard(w, sp, mesh).to(dev)
            worst = max(worst, (float((g - w).abs().max())
                                / max(sc, 1e-30), name))
            if "model" not in mentioned(sp):
                digests.append(int.from_bytes(hashlib.sha256(
                    g.cpu().numpy().tobytes()).digest()[:7], "little"))
        rec["grad_worst"] = worst
        every = comm.all_gather(torch.tensor(digests, dtype=torch.int64),
                                mp, 0, tiled=False)
        rec["replicas_equal"] = bool((every == every[0]).all())
        rec["replicated"] = len(digests)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if dev.type == "cuda" else 0.0
        del params, opt, rows, m, want, model, batch, seen
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[tag] = rec
    return out


def _p12_rzoo_report(res, dev):
    """(l)'s checks and log lines from each rank's ``_p12_rzoo_rank``: the
    loss within 1e-4 relative of the one-rank step's, every gradient
    shard within 2e-4 of its whole leaf's largest entry, the leaves
    replicated over ``model`` bitwise equal across the MP ranks, the
    decode logits elementwise (rtol 2e-4, atol 2e-5) and every state shard
    within 2e-4 of its leaf's largest entry (``pos`` exact), and on the
    card rmsnorm and flash launches per step as ``rzoo_launches``
    predicts.  Returns {path: per-rank launches}."""
    paths = {}
    for arch, tag, layers, (B, L), dec_rows in P12_RZOO:
        cfg = p12_rzoo_cfg(arch, layers)
        recs = [r[tag] for r in res]
        bad = []
        for rk, r in enumerate(recs):
            if abs(r["loss"] - r["want_loss"]) > 1e-4 * abs(r["want_loss"]):
                bad.append(f"rank {rk} loss {r['loss']} vs {r['want_loss']}")
            if r["grad_worst"][0] > 2e-4:
                bad.append(f"rank {rk} gradient {r['grad_worst']}")
            if not (r["replicas_equal"] and r["logits"]["elem_ok"]
                    and r["states_ok"]):
                bad.append(f"rank {rk} replicas {r['replicas_equal']} "
                           f"logits {r['logits']} states {r['states_ok']}")
        train = {k: [r["train_launches"][k] for r in recs]
                 for k in recs[0]["train_launches"]
                 if any(r["train_launches"][k] for r in recs)}
        decode = {k: [r["decode_launches"][k] for r in recs]
                  for k in recs[0]["decode_launches"]
                  if any(r["decode_launches"][k] for r in recs)}
        if dev.type == "cuda":
            per_step = rzoo_launches(cfg)
            per_dec = rzoo_launches(cfg, decode=True)
            for k in ("rmsnorm", "flash_attention"):
                if train.get(k, [0] * 4) != [per_step[k]] * 4 \
                        or decode.get(k, [0] * 4) \
                        != [P12_RZOO_STEPS * per_dec[k]] * 4:
                    bad.append(f"{k} launches train {train} decode {decode}")
        kinds = sorted({k for r in recs for k in r["train_bytes"]})
        log(f"  (l) {arch}, {layers} layers full width on (2, 2): the "
            f"shards made in {max(r['shards_s'] for r in recs):.1f} s; "
            f"a step at {B // 2} x {L} a data rank: loss "
            f"{recs[0]['loss']:.6f} (one rank {recs[0]['want_loss']:.6f}); "
            f"worst gradient {max(r['grad_worst'] for r in recs)} of its "
            f"largest entry; {recs[0]['replicated']} leaves replicated over "
            f"model bitwise equal across MP: "
            f"{all(r['replicas_equal'] for r in recs)}; "
            f"{max(r['train_s'] for r in recs):.2f} s (host clock, the "
            f"collectives timed), peak {max(r['peak_gb'] for r in recs):.2f}"
            f" GB a rank; launches per rank {train}")
        log(f"      collective bytes a training step per rank: "
            + ", ".join(f"{k} {sum(recs[0]['train_bytes'][k].values())}"
                        for k in kinds))
        dk = sorted({k for r in recs for k in r["decode_bytes"]})
        log(f"      decode {dec_rows // 2} rows a data rank, "
            f"{P12_RZOO_STEPS} teacher-forced steps: logits max_abs_err "
            f"{max(r['logits']['err'] for r in recs):.3e} (rtol 2e-4, "
            f"atol 2e-5 on every element: "
            f"{all(r['logits']['elem_ok'] for r in recs)}); every state "
            f"shard within 2e-4 of its leaf: "
            f"{all(r['states_ok'] for r in recs)} ({recs[0]['state_bytes']}"
            f" state bytes a rank, first leaves "
            f"{recs[0]['state_shape']}); "
            f"{max(r['decode_ms'] for r in recs):.2f} ms a step; bytes a "
            f"step per rank "
            + ", ".join(f"{k} {sum(recs[0]['decode_bytes'][k].values())}"
                        for k in dk)
            + f"; launches per rank {decode}")
        if bad:
            raise AssertionError(f"phase 12 (l) {arch}: " + " | ".join(bad))
        paths[f"train_{tag}_mesh"] = train
        paths[f"decode_{tag}_mesh"] = decode
    return paths


# --- phase 12 (m): the cross-attention kinds across ranks -------------------

#: (m): (arch, path tag, layers, global (batch, seq) trained, decode rows)
#: at full width on the merged (2, 2) mesh: llama-3.2-vision cut to one
#: ``dense`` and one ``cross`` layer (``cross_every=2``; 6.1 GB in f32, the
#: embedding and the head 2.1 GB each: ~3.1 GB a rank, ~12 a rank
#: training), its 32 / 8 heads 16 / 4 a rank; whisper-tiny whole (a
#: 4-layer encoder over 1500 frames, 4 ``xdec`` layers), its 6 heads 3 a
#: rank.  One data rank trains 1 x 2048 over 1601 context embeddings and 8
#: x 448 over 8 x 1500 frames; 8 rows a data rank decode.
P12_XZOO = (("llama-3.2-vision-11b", "vision", 2, (2, 2048), 16),
            ("whisper-tiny", "whisper", 4, (16, 448), 16))
#: teacher-forced decode steps through ``ctx_kv``, from an empty cache
P12_XZOO_STEPS = 16


def p12_xzoo_cfg(arch, layers):
    """(m)'s config: ``arch`` at full width cut to ``layers`` (a cross
    layer every 2nd where the arch has them)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return replace(cfg, n_layers=layers,
                   cross_every=2 if cfg.cross_every else 0)


def _p12_xzoo_inputs(cfg, dec_rows, B, L, dev):
    """(m)'s training batch (``SyntheticLM`` batch 0, B x L, with B
    context embeddings or frames, ``ctx_embeds``), decode tokens
    (``dec_rows`` x ``P12_XZOO_STEPS``) and decode context, the same in
    the reference and on every rank."""
    import torch
    batch, toks = _p12_rzoo_inputs(cfg, dec_rows, B, L, dev)
    n = cfg.n_ctx_tokens if cfg.arch_type == "vlm" else cfg.encoder_seq
    g = torch.Generator(device=dev).manual_seed(12)
    batch["ctx_embeds"] = torch.randn((B, n, cfg.d_model), generator=g,
                                      device=dev)
    ctx = torch.randn((dec_rows, n, cfg.d_model), generator=g, device=dev)
    return batch, toks, ctx


def _p12_xzoo_reference(dev, path, writers):
    """(m)'s one-rank runs on the card, made before the spawn (each model
    freed before the next): per config the whole model from seed 0 with
    ``XZOO_GATES``, ``Model.ctx_kv`` over the decode context and
    ``P12_XZOO_STEPS`` teacher-forced ``decode_step`` logits through it,
    then one ``make_train_step`` step's loss and the gradients it hands
    AdamW, with each leaf's largest entry; written to ``path`` +
    ``_<tag>.pt`` behind (``_save_behind``)."""
    import torch
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import loop
    for arch, tag, layers, (B, L), dec_rows in P12_XZOO:
        t0 = time.perf_counter()
        cfg = p12_xzoo_cfg(arch, layers)
        model = Model(cfg, device=dev)
        batch, toks, ctx = _p12_xzoo_inputs(cfg, dec_rows, B, L, dev)
        full = model.init(torch.Generator(device=dev).manual_seed(0))
        set_gates(model, full)
        cache = model.init_cache(dec_rows, P12_XZOO_STEPS)
        logits = []
        with torch.no_grad():
            kv = model.ctx_kv(full, {"ctx_embeds": ctx})
            for t in range(P12_XZOO_STEPS):
                lg, cache = model.decode_step(full, cache, {
                    "tokens": toks[:, t:t + 1], "step": t}, ctx_kv=kv)
                logits.append(lg)
        ref = {"logits": torch.stack(logits).cpu()}
        del cache, logits, kv
        seen = []
        with _catching_grads(seen):
            _, opt, m = loop.make_train_step(model, AdamWConfig())(
                full, adamw_init(full), batch)
        ref["loss"] = float(m["loss"])
        ref["g_scale"] = [float(g.abs().max()) for g in seen]
        ref["g"] = [g.cpu() for g in seen]
        del full, opt, m, seen
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _save_behind(ref, f"{path}_{tag}.pt", writers)
        log(f"  (m) {arch}'s one-rank reference in "
            f"{time.perf_counter() - t0:.1f} s (written behind)")
        del ref


def _p12_xzoo_rank(rank, path):
    """(m) on one rank of the (2, 2) mesh, for each of ``P12_XZOO``: its
    shards of the parameters from seed 0 with ``XZOO_GATES`` (the whole
    model made in turn, one rank at a time) and of the one-rank reference
    (``path``, ``_p12_xzoo_reference``), then ``Model.ctx_kv`` (this
    rank's rows and kv heads; whisper's encoder Megatron-split) and the
    decode steps through it, and one ``make_train_step`` step over this
    rank's rows and their context, the gradients caught where the step
    hands them to AdamW.  Returns per config the readings, the launches,
    host seconds, each collective's bytes a step and the peak memory."""
    import hashlib

    import torch
    import torch.distributed as dist
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import leaves
    from repro_torch.parallel import comm
    from repro_torch.parallel.mesh import ParallelDims, make_mesh
    from repro_torch.parallel.sharding import (P, local_shard, local_tree,
                                               mentioned)
    from repro_torch.train import cache_specs, loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = _p12_device()
    mesh = make_mesh((2, 2), ("data", "model"))
    dims = ParallelDims(dp=("data",), mp=("model",))
    mp = mesh.group(("model",))

    def rows(t):
        return local_shard(t, P(dims.batch_axes, *([None] * (t.dim() - 1))),
                           mesh)

    out = {}
    for arch, tag, layers, (B, L), dec_rows in P12_XZOO:
        t0 = time.perf_counter()
        cfg = p12_xzoo_cfg(arch, layers)
        model = Model(cfg, device=dev)
        batch, toks, ctx = _p12_xzoo_inputs(cfg, dec_rows, B, L, dev)
        params = None
        for turn in range(dist.get_world_size()):
            if turn == rank:
                full = model.init(torch.Generator(device=dev).manual_seed(0))
                set_gates(model, full)
                params = _clone(local_tree(full, model.param_specs(
                    full, mesh, dims), mesh))
                del full
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        want = _load_when_written(f"{path}_{tag}.pt")
        rec = {"shards_s": time.perf_counter() - t0}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # decode: ctx_kv over this rank's rows, then the steps through it
        cspecs = cache_specs(model, mesh, dims, dec_rows, P12_XZOO_STEPS)
        cache = model.init_cache(dec_rows, P12_XZOO_STEPS, mesh=mesh,
                                 dims=dims, specs=cspecs)
        mine = rows(toks)
        wrappers = reset_counts()
        logits = []
        with torch.no_grad():
            _sync(dev)
            t0 = time.perf_counter()
            kv = model.ctx_kv(params, {"ctx_embeds": rows(ctx)}, mesh=mesh,
                              dims=dims)
            _sync(dev)
            rec["ctx_kv_s"] = time.perf_counter() - t0
            rec["ctx_kv_mb"] = sum(t.numel() * t.element_size()
                                   for r in kv.values()
                                   for t in r.values()) / 1e6
            rec["ctx_kv_shape"] = tuple(next(iter(kv.values()))["k"].shape)
            for t in range(P12_XZOO_STEPS):
                if t == P12_XZOO_STEPS - 1:
                    _sync(dev)
                    rec["decode_ms"] = (time.perf_counter() - t0) * 1e3 / t
                    comm.timing(True)
                elif t == 0:
                    _sync(dev)
                    t0 = time.perf_counter()
                lg, cache = model.decode_step(params, cache, {
                    "tokens": mine[:, t:t + 1], "step": t}, mesh=mesh,
                    dims=dims, specs=cspecs, ctx_kv=kv)
                logits.append(lg)
        rec["decode_bytes"] = comm.bytes_out()
        comm.timing(False)
        rec["decode_launches"] = read_counts(wrappers)
        rec["logits"] = _p12_err(torch.stack(logits), local_shard(
            want["logits"], P(None, dims.batch_axes, None, None),
            mesh).to(dev))
        del cache, logits, kv
        # training: one make_train_step step from the same shards
        mine = {k: rows(v) for k, v in batch.items()}
        opt = adamw_init(params)
        specs = leaves(model.param_specs(params, mesh, dims))
        names = _paths(params)
        seen = []
        wrappers = reset_counts()
        comm.timing(True)
        _sync(dev)
        t0 = time.perf_counter()
        with _catching_grads(seen):
            _, _, m = loop.make_train_step(model, AdamWConfig(), None, mesh,
                                           dims)(params, opt, mine)
        _sync(dev)
        rec["train_s"] = time.perf_counter() - t0
        rec["train_bytes"] = comm.bytes_out()
        comm.timing(False)
        rec["train_launches"] = read_counts(wrappers)
        rec["loss"], rec["want_loss"] = float(m["loss"]), want["loss"]
        worst, digests = (0.0, ""), []
        scale_of = dict(zip(names, want["g_scale"]))
        for name, g, w, sc, sp in zip(names, seen, want["g"],
                                      want["g_scale"], specs):
            if name.endswith(".bk") and not cfg.use_rope:
                # whisper's key bias shifts every score of a query by one
                # constant: its exact gradient is zero and both runs round
                # to ~1e-10, held to its ``wk``'s scale (the CPU tests')
                sc = scale_of[name[:-2] + "wk"]
            w = local_shard(w, sp, mesh).to(dev)
            worst = max(worst, (float((g - w).abs().max())
                                / max(sc, 1e-30), name))
            if "model" not in mentioned(sp):
                digests.append(int.from_bytes(hashlib.sha256(
                    g.cpu().numpy().tobytes()).digest()[:7], "little"))
            del w
        rec["grad_worst"] = worst
        every = comm.all_gather(torch.tensor(digests, dtype=torch.int64),
                                mp, 0, tiled=False)
        rec["replicas_equal"] = bool((every == every[0]).all())
        rec["replicated"] = len(digests)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if dev.type == "cuda" else 0.0
        del params, opt, mine, m, want, model, batch, seen
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[tag] = rec
    return out


def _p12_xzoo_report(res, dev):
    """(m)'s checks and log lines from each rank's ``_p12_xzoo_rank``: the
    loss within 1e-4 relative of the one-rank step's, every gradient
    shard within 2e-4 of its whole leaf's largest entry (whisper's key
    biases of their ``wk``'s), the leaves replicated over ``model``
    bitwise equal across the MP ranks, the decode logits elementwise
    (rtol 2e-4, atol 2e-5), and on the card rmsnorm and flash launches
    per rank as ``xzoo_launches`` predicts
    (the decode path's flash: whisper's encoder in ``ctx_kv``).  Returns
    {path: per-rank launches}."""
    paths = {}
    for arch, tag, layers, (B, L), dec_rows in P12_XZOO:
        cfg = p12_xzoo_cfg(arch, layers)
        recs = [r[tag] for r in res]
        bad = []
        for rk, r in enumerate(recs):
            if abs(r["loss"] - r["want_loss"]) > 1e-4 * abs(r["want_loss"]):
                bad.append(f"rank {rk} loss {r['loss']} vs {r['want_loss']}")
            if r["grad_worst"][0] > 2e-4:
                bad.append(f"rank {rk} gradient {r['grad_worst']}")
            if not (r["replicas_equal"] and r["logits"]["elem_ok"]):
                bad.append(f"rank {rk} replicas {r['replicas_equal']} "
                           f"logits {r['logits']}")
        train = {k: [r["train_launches"][k] for r in recs]
                 for k in recs[0]["train_launches"]
                 if any(r["train_launches"][k] for r in recs)}
        decode = {k: [r["decode_launches"][k] for r in recs]
                  for k in recs[0]["decode_launches"]
                  if any(r["decode_launches"][k] for r in recs)}
        if dev.type == "cuda":
            per_step = xzoo_launches(cfg)
            per_dec = {k: P12_XZOO_STEPS * v for k, v in
                       xzoo_launches(cfg, decode=True).items()}
            per_dec["flash_attention"] = cfg.encoder_layers \
                if cfg.arch_type == "audio" else 0
            for k in ("rmsnorm", "flash_attention"):
                if train.get(k, [0] * 4) != [per_step[k]] * 4 \
                        or decode.get(k, [0] * 4) != [per_dec[k]] * 4:
                    bad.append(f"{k} launches train {train} decode {decode}"
                               f"; predicted {per_step[k]} and {per_dec[k]}")
        kinds = sorted({k for r in recs for k in r["train_bytes"]})
        log(f"  (m) {arch}, {layers} layers {cfg.runs()} full width on "
            f"(2, 2): the shards made in "
            f"{max(r['shards_s'] for r in recs):.1f} s; a step at "
            f"{B // 2} x {L} a data rank: loss {recs[0]['loss']:.6f} (one "
            f"rank {recs[0]['want_loss']:.6f}); worst gradient "
            f"{max(r['grad_worst'] for r in recs)} of its largest entry; "
            f"{recs[0]['replicated']} leaves replicated over model bitwise "
            f"equal across MP: {all(r['replicas_equal'] for r in recs)}; "
            f"{max(r['train_s'] for r in recs):.2f} s (host clock, the "
            f"collectives timed), peak {max(r['peak_gb'] for r in recs):.2f}"
            f" GB a rank; launches per rank {train}")
        log(f"      collective bytes a training step per rank: "
            + ", ".join(f"{k} {sum(recs[0]['train_bytes'][k].values())}"
                        for k in kinds))
        dk = sorted({k for r in recs for k in r["decode_bytes"]})
        log(f"      decode {dec_rows // 2} rows a data rank: ctx_kv "
            f"{recs[0]['ctx_kv_shape']} a layer ({recs[0]['ctx_kv_mb']:.1f}"
            f" MB a rank) in {max(r['ctx_kv_s'] for r in recs):.2f} s, "
            f"{P12_XZOO_STEPS} teacher-forced steps: logits max_abs_err "
            f"{max(r['logits']['err'] for r in recs):.3e} (rtol 2e-4, "
            f"atol 2e-5 on every element: "
            f"{all(r['logits']['elem_ok'] for r in recs)}); "
            f"{max(r['decode_ms'] for r in recs):.2f} ms a step; bytes a "
            f"step per rank "
            + ", ".join(f"{k} {sum(recs[0]['decode_bytes'][k].values())}"
                        for k in dk)
            + f"; launches per rank {decode}")
        if bad:
            raise AssertionError(f"phase 12 (m) {arch}: " + " | ".join(bad))
        paths[f"train_{tag}_mesh"] = train
        paths[f"decode_{tag}_mesh"] = decode
    return paths


def multirank(dev, model_cfg=None, tokens=(8, 1024), block_cfg=None,
              block_tokens=(2, 2048), p9_losses=None, kv_cfg=None):
    """Phase 12 (see the module docstring) on ``model_cfg`` (default
    gpt2-moe, full size) with ``tokens`` = (batch, seq) global tokens, and
    (d) on ``block_cfg`` (default ``p12_block_cfg`` of qwen3-moe-30b-a3b)
    with ``block_tokens``; (e) holds its losses to ``p9_losses`` (phase 9
    (a)'s; made here, on one rank, when phase 9 did not run).  Returns
    {path: per-rank launches} of every multi-rank path."""
    import tempfile

    from repro_torch.launch.mesh import spawn
    log("  ranks share cuda:0 over gloo: one card, and NCCL refuses two "
        "ranks on one card ('Duplicate GPU detected'); gloo stages every "
        "collective through the host, so the times below are the host's, "
        "not NVLink's")
    from repro_torch.configs import get_config
    model_cfg = model_cfg or get_config("gpt2-moe")
    block_cfg = block_cfg or p12_block_cfg(get_config("qwen3-moe-30b-a3b"))
    kv_cfg = kv_cfg or p12_kv_cfg()
    paths = {}
    cpu = dev.type == "cpu"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p12_") as tmp:
        # the one-rank references: (a)'s layer, (b)'s training
        t0 = time.perf_counter()
        ref_path = os.path.join(tmp, "layer_ref.pt")
        _p12_layer_refs(dev, ref_path, model_cfg, tokens)
        ref = _p12_one_rank_train(dev, P12_STEPS, model_cfg, tokens)
        if p9_losses is None:
            p9_losses = p9_reference_losses(dev, model_cfg, tokens,
                                            P12_GUARD_STEPS)
        # (a) on the distinct (2, 2, 2) mesh: 8 ranks
        (label, kind), shape, _, _ = P12_DISTINCT
        res = spawn(_p12_layer_rank, 8, kind, ref_path, model_cfg,
                    backend="gloo", device=dev.type, timeout=600,
                    threads=1 if cpu else None)
        failed = _p12_report(label, 8, res, paths)
        log(f"  (a) {label} in {time.perf_counter() - t0:.1f} s (the "
            "one-rank references included)")
        # (a), (b) and (c) on the merged (2, 2) mesh: 4 ranks, one spawn;
        # (k)'s one-rank reference first, its model freed before the spawn
        t0 = time.perf_counter()
        kv_ref = os.path.join(tmp, "kv_ref.pt")
        _p12_kv_reference(dev, kv_cfg, kv_ref)
        log(f"  (k) the one-rank reference in {time.perf_counter() - t0:.1f}"
            " s")
        # (l)'s and (m)'s references, written to disk behind the spawn
        # (the ranks read them after (k))
        writers = []
        rzoo_ref = os.path.join(tmp, "rzoo_ref")
        _p12_rzoo_reference(dev, rzoo_ref, writers)
        xzoo_ref = os.path.join(tmp, "xzoo_ref")
        _p12_xzoo_reference(dev, xzoo_ref, writers)
        t0 = time.perf_counter()
        scheds = P12_TRAIN_SCHEDS
        guard_dir = os.path.join(tmp, "guarded")
        try:
            res = spawn(_p12_merged_rank, 4, ref_path, model_cfg, scheds,
                        P12_STEPS, tokens, block_cfg, block_tokens,
                        guard_dir, kv_cfg, kv_ref, rzoo_ref, xzoo_ref,
                        backend="gloo", device=dev.type, timeout=900,
                        threads=2 if cpu else None)
        finally:
            for w in writers:
                w.join()
        for w in writers:
            if w.error is not None:
                raise w.error
        log("  (l) and (m)'s references written behind the spawn in "
            + ", ".join(f"{w.seconds:.1f}" for w in writers) + " s")
        (label, _), _, _, _ = P12_MERGED
        failed += _p12_report(label, 4, [r["layer"] for r in res], paths)
        if failed:
            raise AssertionError(f"phase 12 (a): {failed} outside their "
                                 f"limits (the lines above)")
        paths.update(_p12_overlap_report([r["overlap"] for r in res]))
        for sched in scheds:
            per_rank = [r["train"][sched] for r in res]
            for step in range(P12_STEPS):
                want = ref[step]
                for rk, rr in enumerate(per_rank):
                    got = rr["rows"][step]
                    if not (abs(got["loss"] - want["loss"])
                            <= 1e-4 * abs(want["loss"])
                            and abs(got["grad_norm"] - want["grad_norm"])
                            <= 1e-3 * want["grad_norm"]):
                        raise AssertionError(
                            f"phase 12 (b) {sched} rank {rk} step {step}: "
                            f"loss {got['loss']} grad norm "
                            f"{got['grad_norm']}; one rank {want['loss']} "
                            f"/ {want['grad_norm']}")
            r0 = per_rank[0]["rows"]
            log(f"  (b) {sched}: losses "
                + " ".join(f"{x['loss']:.6f}" for x in r0) + " (one rank "
                + " ".join(f"{x['loss']:.6f}" for x in ref) + "); grad "
                "norms " + " ".join(f"{x['grad_norm']:.6f}" for x in r0)
                + " (one rank " + " ".join(f"{x['grad_norm']:.6f}"
                                          for x in ref)
                + "); the first step taken twice torch.equal on every rank")
            one_ms = sum(x["ms"] for x in ref[1:]) / len(ref[1:])
            for rk, rr in enumerate(per_rank):
                last = rr["rows"][1:]
                ms = sum(x["ms"] for x in last) / len(last)
                shares = {}
                for x in last:
                    for k, (_, nb, sec) in x["comm"].items():
                        shares[k] = shares.get(k, 0.0) + sec * 1e3
                log(f"  (c) {sched} rank {rk}: {ms:.1f} ms/step after the "
                    f"first (one rank: {one_ms:.1f}); "
                    "collectives (host, gloo) "
                    + ", ".join(f"{k} {v / len(last):.1f} ms "
                                f"({100 * v / len(last) / ms:.1f}%)"
                                for k, v in sorted(shares.items())))
            paths[f"train_2x2_{sched}"] = {
                k: [rr["launches"][k] for rr in per_rank]
                for k in per_rank[0]["launches"]
                if any(rr["launches"][k] for rr in per_rank)}
        paths.update(_p12_measured_report([r["measured"] for r in res]))
        paths.update(_p12_block_report([r["block"] for r in res],
                                       block_cfg))
        log(f"  (d) in {max(r['block']['total_s'] for r in res):.1f} s "
            "(the one-rank references, one rank at a time, included)")
        paths.update(_p12_serve_report([r["serve"] for r in res],
                                       block_cfg))
        paths.update(_p12_placed_report([r["placed"] for r in res]))
        layer_s = max(sum(c["ms"] for c in r["placed"]["layer"])
                      for r in res) / 1e3
        train_s = max(r["placed"]["train_s"] for r in res)
        serve_s = max(r["placed"]["serve_s"] for r in res)
        log(f"  (i) in {layer_s + train_s + serve_s:.1f} s (layer "
            f"{layer_s:.1f}, training {train_s:.1f}, serving "
            f"{serve_s:.1f})")
        paths.update(_p12_guarded_report([r["guarded"] for r in res],
                                         p9_losses, dev, model_cfg, tokens))
        paths.update(_p12_kv_report([r["kv"] for r in res], kv_cfg))
        paths.update(_p12_rzoo_report([r["rzoo"] for r in res], dev))
        log(f"  (l) in {max(r['rzoo_s'] for r in res):.1f} s a rank")
        paths.update(_p12_xzoo_report([r["xzoo"] for r in res], dev))
        log(f"  (m) in {max(r['xzoo_s'] for r in res):.1f} s a rank")
    log(f"  (a) 2x2, (b)-(m) in {time.perf_counter() - t0:.1f} s")
    return paths


def _p12_measured_report(res):
    """(h)'s checks and log lines from each rank's ``_p12_measured``: the
    same times, picks and wire decision on every rank, at most four
    candidates, the output under the pick ``torch.equal`` to the forced
    one on every rank, ``P12_MEASURED_USES`` launched on every rank.
    Returns {path: per-rank launches}."""
    r0 = res[0]
    same = all(r["times"] == r0["times"] and r["pick"] == r0["pick"]
               and r["wire_times"] == r0["wire_times"]
               and r["wire"] == r0["wire"] for r in res)
    per_rank = {k: [r["launches"][k] for r in res] for k in r0["launches"]
                if any(r["launches"][k] for r in res)}
    bad = [k for k in P12_MEASURED_USES if min(per_rank.get(k, [0])) < 1]
    log("  (h) measured on (2, 2), the slowest rank's median ms: "
        + ", ".join(f"{c[0]} {1e3 * t:.2f}" for c, t in r0["times"])
        + f" -> {r0['pick']}; under apply_moe with an auto wire: "
        + ", ".join(f"{c[2]} {1e3 * t:.2f}" for c, t in r0["wire_times"])
        + f" -> {r0['wire']}; the same on every rank: {same}; the output "
        f"torch.equal to {r0['wire']} forced on every rank: "
        f"{all(r['equal'] for r in res)}; launches per rank {per_rank}; "
        f"{max(r['s'] for r in res):.1f} s")
    if not same or len(r0["times"]) > 4 or bad or not all(
            r["equal"] for r in res):
        raise AssertionError(f"phase 12 (h): same {same}, "
                             f"{len(r0['times'])} candidates, kernels {bad} "
                             f"not launched on every rank, equal "
                             f"{[r['equal'] for r in res]}")
    return {"autosched_2x2_measured": per_rank}


def _p12_serve_report(res, block_cfg):
    """(g)'s checks and log lines from each rank's ``_p12_serve_rank``;
    returns {path: per-rank launches}."""
    n = len(p12_serve_prompts(block_cfg.vocab_size))
    paths = {}
    log(f"  (g) {block_cfg.name} one block, vocab {block_cfg.vocab_size}, "
        f"served on (2, 2): {n} requests x {P12_SERVE_GEN} tokens; rank 0's "
        f"one-rank run {res[0]['ref_wall']:.2f} s")
    for mode, _, _ in P12_SERVE_MODES:
        runs = [r[mode] for r in res]
        per_rank = {k: [r["launches"][k] for r in runs]
                    for k in runs[0]["launches"]
                    if any(r["launches"][k] for r in runs)}
        bad = [k for k in P12_SERVE_USES[mode]
               if min(per_rank.get(k, [0])) < 1]
        st = runs[0]["stats"]
        for rk, r in enumerate(runs):
            lat, wall = r["latency"], r["wall"]
            log(f"  (g) {mode} rank {rk}: {lat['tok_per_s']:.1f} tok/s, p50 "
                f"{lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms (host, "
                f"gloo); collectives "
                + ", ".join(f"{k} {1e3 * v[2]:.1f} ms "
                            f"({100 * v[2] / wall:.1f}%)"
                            for k, v in sorted(r["comm"].items())))
        ties = runs[0]["ties"]
        log(f"  (g) {mode}: {st['prefill_calls']} prefill calls for "
            f"{st['admitted']} admissions, {st['decode_calls']} decode "
            f"rounds, prefix hits {st['prefix_hits']}; first logits "
            f"max_abs_err {max(r['first_err'] for r in runs):.3e}; streams "
            f"off the one-rank run at a top-2 tie: "
            f"{sum(len(r['ties']) for r in runs)} "
            + (f"(rank 0: {[(a, b, f'{g:.2e}', f'{t:.2e}') for a, b, g, t in ties]}) "
               if ties else "")
            + f"; launches per rank {per_rank}")
        failed = [rk for rk, r in enumerate(runs) if not (
            r["complete"] and r["live"] == 0 and r["agreed"]
            and r["first_ok"] and not r["off"]
            and r["stats"]["prefill_calls"] == r["stats"]["admitted"] == n)]
        if failed or bad:
            raise AssertionError(
                f"phase 12 (g) {mode}: ranks {failed} failed "
                f"({[(r['complete'], r['live'], r['agreed'], r['first_ok'], r['off'], r['stats']) for r in runs]}); "
                f"kernels {bad} not launched on every rank")
        paths[f"serve_2x2_{mode}"] = per_rank
    if not all("decode" in r["summary"] for r in res):
        raise AssertionError(f"phase 12 (g): no decode decision: "
                             f"{res[0]['summary']}")
    log(f"  (g) in {max(r['s'] for r in res):.1f} s")
    return paths


#: the kernels (d) must launch on every rank (qwen3: rmsnorm, and flash
#: attention on the rank's own heads)
P12_BLOCK_USES = ("rmsnorm", "flash_attention")


def _p12_block_report(res, cfg):
    """(d)'s checks and log lines from each rank's ``_p12_block_rank``:
    the loss within 1e-4 relative of the one-rank run's, the backbone's
    output elementwise (rtol 2e-4, atol 2e-5) and every gradient within
    2e-4 of its largest entry (``_p12_ok`` at f32), the routed rows the
    one-rank runs' exactly, ``P12_BLOCK_USES`` launched on every rank.
    Returns {path: per-rank launches}."""
    paths = {}
    for name in P12_BLOCK_MESHES:
        cases = [r[name] for r in res]
        per_rank = {k: [c["launches"][k] for c in cases]
                    for k in cases[0]["launches"]
                    if any(c["launches"][k] for c in cases)}
        bad = [k for k in P12_BLOCK_USES if min(per_rank.get(k, [0])) < 1]
        if bad:
            raise AssertionError(f"phase 12 (d) {name}: {bad} not launched "
                                 f"on every rank: {per_rank}")
        worst = {k: max((c["reads"][k] for c in cases),
                        key=lambda r: r["err"] / r["scale"])
                 for k in cases[0]["reads"]}
        off = [k for k, r in worst.items() if not _p12_ok(r, "f32",
                                                          k == "y")]
        loss_off = [c["loss"] for c in cases
                    if abs(c["loss"] - c["want_loss"])
                    > 1e-4 * abs(c["want_loss"])]
        top = sorted((k for k in worst if k != "y"),
                     key=lambda k: -worst[k]["err"] / worst[k]["scale"])[:3]
        log(f"  (d) {name}: {cfg.name} one block, vocab {cfg.vocab_size}: "
            f"loss {cases[0]['loss']:.6f} (one rank "
            f"{cases[0]['want_loss']:.6f}); y max_abs_err "
            f"{worst['y']['err']:.3e}; worst gradients "
            + ", ".join(f"{k} {worst[k]['err'] / worst[k]['scale']:.3e}"
                        for k in top)
            + f" of max(1, max|want|); launches per rank {per_rank}; "
            f"{max(c['s'] for c in cases):.2f} s forward and backward")
        if off or loss_off or not all(c["load_ok"] for c in cases):
            raise AssertionError(
                f"phase 12 (d) {name}: {off} outside their limits, losses "
                f"{loss_off}, routed rows equal "
                f"{[c['load_ok'] for c in cases]}")
        paths[f"block_qwen3_{name}"] = per_rank
    return paths


# --- phase 13: the five configs whose block kinds the port runs -------------

#: (arch, layers kept at full width (None: all)); command-r runs none of the
#: seven kernels: its layernorm is inline, paged attention plain code and its
#: dense FFN ``torch.matmul``, all as in JAX
ZOO = ((L4, N_LAYERS), ("command-r-35b", N_LAYERS), ("yi-9b", N_LAYERS),
       ("mistral-nemo-12b", N_LAYERS), ("qwen1.5-0.5b", None))
#: each arch's path name in the kernels line
ZOO_PATH = {L4: "llama4", "command-r-35b": "command_r", "yi-9b": "yi_9b",
            "mistral-nemo-12b": "mistral_nemo", "qwen1.5-0.5b": "qwen1_5"}
#: (b): llama4's long request, one chunk of 8192 and 64 tokens past it,
#: prefilled in chunks of ``ZOO_CHUNK``
ZOO_LONG = 8192 + 64
ZOO_CHUNK = 512
#: (b): the chunk widened past the request: the mask lifted, the layer kinds
#: (and so the parameters and the NoPE fourth layer) unchanged, where
#: ``attn_chunk=None`` would also turn the fourth layer into a RoPE layer
ZOO_NO_CHUNK = 16384


def zoo_long_request(model, params, dev):
    """Phase 13 (b): one 8256-token request at the drop-free capacity
    factor, prefilled through ``paged_step`` in 512-token chunks (the
    engine's buckets) and served through ``Engine``; its last-position
    logits against ``Model.forward`` over the same tokens (the training
    path: ``sdpa_flash_scan``'s chunk mask) within 1e-3 of the logits'
    scale, the same greedy token, and the engine's first token that one;
    the forward with the chunk widened past the request must differ by
    more than the tolerance."""
    from dataclasses import replace

    import numpy as np
    import torch
    from repro_torch.models import Model
    from repro_torch.serve import Engine
    from repro_torch.serve.engine import prefill_bucket
    cfg = model.cfg
    moe = cfg.moe
    free = Model(replace(cfg, moe=replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)), device=dev)
    prompt = np.random.RandomState(13).randint(0, cfg.vocab_size, ZOO_LONG)
    bs, max_len = 16, ZOO_LONG + 64
    nb = max_len // bs
    cache = free.init_cache(nb + 1, bs)
    table = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None]
    t0 = time.perf_counter()
    with torch.no_grad():
        for c0 in range(0, ZOO_LONG, ZOO_CHUNK):
            n = min(ZOO_CHUNK, ZOO_LONG - c0)
            toks = np.zeros((1, prefill_bucket([n], max_len)), np.int32)
            toks[0, :n] = prompt[c0:c0 + n]
            batch = {"tokens": torch.from_numpy(toks).to(dev),
                     "starts": torch.tensor([c0], dtype=torch.int32,
                                            device=dev),
                     "lens": torch.tensor([n], dtype=torch.int32,
                                          device=dev),
                     "tables": table}
            paged, _ = free.paged_step(params, cache, batch, infer=False)
        torch.cuda.synchronize()
        t_paged = time.perf_counter() - t0
        del cache
        tokens = {"tokens": torch.from_numpy(prompt[None]).to(dev)}
        last = {}
        for label, c in (("chunked", cfg.attn_chunk),
                         ("widened", ZOO_NO_CHUNK)):
            m = Model(replace(free.cfg, attn_chunk=c), device=dev)
            if m.runs != free.runs:
                raise AssertionError(f"phase 13 (b): runs {m.runs}")
            t0 = time.perf_counter()
            logits, _ = m.forward(params, tokens)
            last[label] = logits[:, -1].clone()
            del logits
            torch.cuda.synchronize()
            last[label + "_s"] = time.perf_counter() - t0
    want = last["chunked"]
    err = compare("phase 13 (b): paged chunks vs Model.forward", paged, want,
                  1e-3)
    greedy = int(want.argmax(-1))
    if int(paged.argmax(-1)) != greedy:
        raise AssertionError("phase 13 (b): greedy token differs between the "
                             "paged chunks and Model.forward")
    scale = max(1.0, want.abs().max().item())
    gap = (last["widened"] - want).abs().max().item()
    if not gap > 1e-3 * scale:
        raise AssertionError(f"phase 13 (b): the widened chunk moves the "
                             f"last logits by {gap:.3e}, within 1e-3 * "
                             f"{scale:.3g}: the mask does not bite")
    eng = Engine(free, max_batch=1, max_len=max_len, block_size=bs,
                 prefill_chunk=ZOO_CHUNK)
    eng.submit(list(prompt), 4, rid=0)
    t0 = time.perf_counter()
    (done,) = eng.run(params)
    wall = time.perf_counter() - t0
    if done.tokens[0] != greedy or len(done.tokens) != 4:
        raise AssertionError(f"phase 13 (b): the engine served "
                             f"{done.tokens}, Model.forward's greedy token "
                             f"is {greedy}")
    log(f"  (b) {ZOO_LONG} tokens, chunk {cfg.attn_chunk}, capacity factor "
        f"{free.cfg.moe.capacity_factor:g}: {-(-ZOO_LONG // ZOO_CHUNK)} "
        f"paged chunks of {ZOO_CHUNK} in {t_paged:.2f} s vs Model.forward "
        f"({last['chunked_s']:.2f} s): last logits max_abs_err {err:.3e} "
        f"(tol 1e-3 * {scale:.3g}), greedy token {greedy} both; chunk "
        f"widened to {ZOO_NO_CHUNK}: max |d| {gap:.3e}; the engine "
        f"({eng.stats['prefill_calls']} prefill calls) served "
        f"{done.tokens} in {wall:.2f} s")


#: (c): the KV-cache serve path on mistral-nemo-12b: 4 right-padded prompts
#: of ``ZOO_KV_LENS`` tokens, ``ZOO_KV_GEN`` greedy serve steps after the
#: prefill; every step's logits held to ``Model.forward`` within
#: ``ZOO_KV_TOL`` of their scale (stated before the first run: 4 layers of
#: f32 sums in another order, as (b)'s 1e-3)
ZOO_KV_LENS = (2048, 1536, 1024, 1800)
ZOO_KV_GEN = 32
ZOO_KV_TOL = 1e-3


def zoo_kv_cache(model, params, dev):
    """Phase 13 (c): ``prefill_step`` over ``ZOO_KV_LENS``' prompts (right-
    padded to the longest, the flash kernel's serving launch), then
    ``ZOO_KV_GEN`` greedy ``make_serve_step`` steps with each row at its
    own position (``kv_run``); launches counted over that run.  Every
    step's logits within ``ZOO_KV_TOL`` of the logits' scale of
    ``Model.forward`` over prompt + tokens, with the same greedy tokens;
    the paged ``Engine`` serving the same prompts, its streams counted
    against these.  Returns the path's launches."""
    import numpy as np
    import torch
    from repro_torch.serve import Engine
    t_all = time.perf_counter()
    cfg = model.cfg
    rng = np.random.RandomState(131)
    L, n_tok = max(ZOO_KV_LENS), ZOO_KV_GEN + 1
    B, max_len = len(ZOO_KV_LENS), L + n_tok
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in ZOO_KV_LENS]
    tokens = torch.zeros((B, L), dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    lengths = torch.tensor(ZOO_KV_LENS)
    wrappers = reset_counts()
    cache, stream, got, t_prefill, t_decode, _ = kv_run(
        model, params, tokens, lengths, ZOO_KV_GEN, max_len, B)
    launches = read_counts(wrappers)
    del cache
    want_launch = {"flash_attention": cfg.n_layers,
                   "rmsnorm": (ZOO_KV_GEN + 1) * (2 * cfg.n_layers + 1)}
    if any(launches[k] != v for k, v in want_launch.items()):
        raise AssertionError(f"phase 13 (c): launches {launches}, want "
                             f"{want_launch}")
    full, pos = teacher_forced(tokens, lengths, stream)
    with torch.no_grad():
        want_logits, _ = model.forward(params, {"tokens": full.to(dev)})
        want = want_logits[torch.arange(B, device=dev)[:, None],
                           pos.to(dev)].cpu()            # (B, n_tok, V)
        del want_logits
    err = compare("phase 13 (c): KV-cache logits vs Model.forward", got,
                  want, ZOO_KV_TOL)
    scale = max(1.0, want.abs().max().item())
    if not torch.equal(got.argmax(-1), want.argmax(-1)) or not torch.equal(
            got.argmax(-1), stream):
        raise AssertionError("phase 13 (c): greedy tokens differ between "
                             "the serve steps, their logits and "
                             "Model.forward")
    del got, want
    eng = Engine(model, max_batch=B, max_len=-(-max_len // 16) * 16,
                 block_size=16)
    for i, p in enumerate(prompts):
        eng.submit(p, n_tok, rid=i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {c.rid: c for c in eng.run(params)}
    wall = time.perf_counter() - t0
    st = serve_report("  (c) the paged engine, the same prompts", done, eng,
                      wall, B, n_tok)
    same = sum(done[i].tokens == stream[i].tolist() for i in range(B))
    log(f"  (c) KV cache: {B} prompts of {list(ZOO_KV_LENS)} tokens, "
        f"prefill_step {t_prefill * 1e3:.1f} ms, {ZOO_KV_GEN} serve steps "
        f"in {t_decode:.3f} s: {B * ZOO_KV_GEN / t_decode:.1f} tok/s, "
        f"{B * n_tok / (t_prefill + t_decode):.1f} with the prefill (the "
        f"paged engine {st['tok_per_s']:.1f} tok/s over its whole run, "
        f"prefills included); the serve steps' logits vs Model.forward "
        f"max_abs_err {err:.3e} (tol {ZOO_KV_TOL:g} * {scale:.3g}), greedy "
        f"tokens equal; {same}/{B} streams identical to the engine's; "
        f"launches {({k: v for k, v in launches.items() if v})}; (c) in "
        f"{time.perf_counter() - t_all:.1f} s")
    return launches


def zoo(dev):
    """Phase 13 (see the module docstring).  Returns the launches of each
    serving and training path by kernel."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.moe import resolve_schedule
    from repro_torch.models import Model
    paths = {}
    gen = 32
    for arch, layers in ZOO:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = replace(cfg, n_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        log(f"  {arch}: full width, {cfg.n_layers} layers {model.runs}: "
            f"{n_bytes / 1e9:.2f} GB of parameters made in "
            f"{time.perf_counter() - t0:.2f} s")
        prompts = make_requests(cfg.vocab_size)
        serve(model, params, prompts[:2], gen=4)      # warm-up (not counted)
        err = reference_check(model, params, prompts[0])
        log(f"    reference check: paged_step logits, kernels vs plain "
            f"versions: max_abs_err {err:.3e}")
        tag = ZOO_PATH[arch]
        runs = [("one-shot", f"serve_{tag}", {})]
        if cfg.moe is not None:
            pick = resolve_schedule(cfg.moe, None, B=8, L=1, infer=True,
                                    device=dev)[0]
            moe_uses = ("expert_ffn_grouped",) if pick == "s1g" else (
                "moe_dispatch", "expert_ffn", "moe_combine")
            log(f"    auto picks {pick} for the decode pool of 8: "
                f"{', '.join(moe_uses)}")
            runs = [("one-shot", f"serve_{tag}_one_shot", {}),
                    ("chunked-32", f"serve_{tag}_chunked_32",
                     {"prefill_chunk": 32}),
                    ("one-shot-s1d", f"serve_{tag}_one_shot_s1d",
                     {"schedule": "s1d"})]
        done_of = {}
        for label, path, kw in runs:
            wrappers = reset_counts()
            done, eng, wall = serve(model, params, prompts, gen=gen, **kw)
            launches = read_counts(wrappers)
            serve_report(f"  {label}", done, eng, wall, len(prompts), gen)
            log(f"    launches {({k: v for k, v in launches.items() if v})}")
            if cfg.moe is None:
                uses = ("rmsnorm",) if cfg.norm_type == "rmsnorm" else ()
            elif kw.get("schedule") == "s1d":
                uses = ("rmsnorm", "moe_dispatch", "expert_ffn",
                        "moe_combine")
            else:
                uses = ("rmsnorm",) + moe_uses
            if any(launches[k] <= 0 for k in uses) or (
                    not uses and any(launches.values())):
                raise AssertionError(f"phase 13 {arch} {label}: launches "
                                     f"{launches}, the path uses {uses}")
            done_of[label] = done
            paths[path] = launches
        if len(runs) > 1:
            same = sum(done_of["one-shot"][i].tokens
                       == done_of["one-shot-s1d"][i].tokens
                       for i in range(len(prompts)))
            log(f"    one-shot under auto vs s1d: {same}/{len(prompts)} "
                f"requests with identical tokens")
        if arch == L4:
            zoo_long_request(model, params, dev)
        if arch == "mistral-nemo-12b":
            paths[f"serve_{tag}_cache"] = zoo_kv_cache(model, params, dev)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, params, done_of, done, eng
        torch.cuda.empty_cache()
        if arch == "qwen1.5-0.5b":
            paths[f"train_{tag}"] = train(
                "qwen1.5", cfg, dev, batch=1, seq=2048, steps=5, lr=1e-4,
                uses=("rmsnorm", "flash_attention"),
                per_step={"rmsnorm": 4 * cfg.n_layers + 1,
                          "flash_attention": 2 * cfg.n_layers,
                          "expert_ffn_grouped": 0, "moe_dispatch": 0})
            from repro_torch.launch.determinism import release_host_blocks
            release_host_blocks()
            peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
        log(f"    {arch} in {time.perf_counter() - t0:.1f} s, peak device "
            f"memory {peak:.2f} GB")
    return paths


# --- phase 14: the dry run --------------------------------------------------

#: (a) and (b): ``dryrun.dry_one``'s arguments (arch, shape, multi_pod,
#: schedule, dtype, save_hlo, cache_seq_shard), traced on the meta device
P14_TRACES = (("a", ("qwen3-moe-30b-a3b", "train_4k", False)),
              ("b", ("qwen3-moe-30b-a3b", "decode_32k", False, None,
                     "bfloat16", False, True)),
              ("a", ("hymba-1.5b", "long_500k", False)),
              ("a", ("xlstm-350m", "decode_32k", False)),
              ("a", ("llama-3.2-vision-11b", "decode_32k", False)),
              ("a", ("whisper-tiny", "decode_32k", False)))
#: the phase's stated limit, seconds (logged beside its time)
P14_LIMIT_S = 45.0
#: (c): the real runs' combos (reduced, float32, 8 x 64 tokens)
P14_GPT2 = ("gpt2-moe", "train_4k")
P14_QWEN = ("qwen1.5-0.5b", "train_4k")
#: (c): the schedule_comparison example's timed calls a row (its command
#: line's default is 5)
P14_COMPARISON_ITERS = 3
#: (c): schedule_comparison's ``max|y - y_base|``.  The rows whose
#: schedule (``auto``'s as its decision names it) gates the baseline's
#: pool must give its bits; the others gate each MP rank's half of it
#: (s1, s1_seqpar, s1 x4), and the card's cuBLAS may sum the gate's
#: logits over a pool of another row count in another order (``(c)``
#: logs that product's difference): those are held to the JAX package's
#: schedule-equivalence atol (``run_schedule_equiv.py``; y is O(1)).
#: On the CPU every row gives the baseline's bits, as in JAX's run
#: (``tests/test_torch_comm_volume_dist.py``)
P14_COMPARISON_EXACT = ("baseline", "s2", "s2h")
P14_COMPARISON_ATOL = 2e-5
#: (c): the kernels each row of schedule_comparison runs on every rank
#: (every row dispatch -> expert_ffn -> combine, s2h under auto included;
#: one launch each a chunk, the SAA pieces sharing one FFN)
P14_COMPARISON_USES = ("moe_dispatch", "expert_ffn", "moe_combine")


def p14_combo(arch, shape_name):
    """A (c) combo's config and shape; a MoE arch at the drop-free
    capacity factor E / k, so that each rank's pool keeps every token and
    the 8 ranks compute what one rank does."""
    from dataclasses import replace

    from repro_torch.launch.dryrun import build_config
    cfg, shape, _ = build_config(arch, shape_name, dtype="float32",
                                 reduced=True, seq=64, batch_size=8)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg, shape


def _p14_rank(rank, job):
    """One rank of (c): gpt2-moe's guarded step (``dryrun.run_rank``),
    then qwen1.5-0.5b's step with whole and with ZeRO-1 moments from one
    state, compared here; each step's kernel launches."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dims_for, make_test_mesh
    from repro_torch.optim.adamw import AdamWConfig, leaves
    from repro_torch.train.loop import make_train_step
    t_in = time.time()
    out = {"gpt2": dryrun.run_rank(rank, job)}
    t_gpt2 = time.time()
    cfg, shape = p14_combo(*P14_QWEN)
    mesh = make_test_mesh()
    dims = dims_for(cfg)
    dev = torch.device("cuda", torch.cuda.current_device())
    stepped = {}
    for zero in ((), ("data",)):
        model, params, opt, batch = dryrun.rank_state(cfg, shape, mesh, dims,
                                                      dev, zero)
        registry.launches(reset=True)
        make_train_step(model, AdamWConfig(), None, mesh, dims,
                        zero)(params, opt, batch)
        torch.cuda.synchronize()
        stepped[zero] = (leaves(params), opt, registry.launches())
    out["zero_equal"] = all(torch.equal(a, b) for a, b in zip(
        stepped[()][0], stepped[("data",)][0]))
    opt_z = stepped[("data",)][1]
    out["moment_bytes"] = sum(t.numel() * t.element_size() for t in
                              leaves(opt_z["mu"]) + leaves(opt_z["nu"]))
    out["launches"] = stepped[("data",)][2]
    t_qwen = time.time()
    # the schedule_comparison example on the same ranks and mesh
    from repro_torch.examples import schedule_comparison
    registry.launches(reset=True)
    out["comparison"] = schedule_comparison.compare(
        mesh, schedule_comparison.DIMS, dev, iters=P14_COMPARISON_ITERS)
    torch.cuda.synchronize()
    out["comparison_launches"] = registry.launches()
    out["clock"] = (t_in, t_gpt2, t_qwen, time.time())
    return out


def _p14_report(label, rec):
    """Log one meta record and check what it must hold."""
    m = rec["memory_analysis"]
    gb = {k: m[k] / 1e9 for k in ("params_bytes", "moments_bytes",
                                  "batch_bytes", "cache_bytes",
                                  "ctx_kv_bytes", "temp_size_in_bytes",
                                  "argument_size_in_bytes")}
    total = gb["argument_size_in_bytes"] + gb["temp_size_in_bytes"]
    rl = rec["roofline"]
    log(f"  ({label}) {rec['arch']} {rec['shape']} on {rec['chips']} ranks "
        f"(rank 0 traced on meta, sched {rec['schedule']}): per rank "
        f"params {gb['params_bytes']:.3f} GB, moments "
        f"{gb['moments_bytes']:.3f} GB, batch {gb['batch_bytes']:.4f} GB, "
        f"cache {gb['cache_bytes']:.3f} GB"
        + (f", ctx_kv {gb['ctx_kv_bytes']:.3f} GB" if m["ctx_kv_bytes"]
           else "") + f", temp "
        f"{gb['temp_size_in_bytes']:.3f} GB, total {total:.3f} GB, "
        f"fits_80gb {rec['fits_80gb']}; trace {rec['trace_s']:.2f} s")
    log(f"      roofline (modeled from the H100 SXM data sheet, not "
        f"measured): compute {rl['t_compute_s'] * 1e3:.3f} ms, memory "
        f"{rl['t_memory_s'] * 1e3:.3f} ms, collective "
        f"{rl['t_collective_s'] * 1e3:.3f} ms -> {rl['bottleneck']}; "
        f"collective bytes a rank by kind {rec['collectives']['bytes']}")
    parts = (m["params_bytes"] + m["opt_state_bytes"] + m["batch_bytes"]
             + m["cache_bytes"] + m["ctx_kv_bytes"])
    if rec["chips"] != 256 or m["argument_size_in_bytes"] != parts \
            or not m["temp_size_in_bytes"] > 0 \
            or not all(math.isfinite(rl[k]) and rl[k] > 0 for k in (
                "t_compute_s", "t_memory_s", "t_collective_s")) \
            or rec["fits_80gb"] != (
                m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
                <= 80e9):
        raise AssertionError(f"phase 14 ({label}): record {m}, roofline "
                             f"{rl}, fits {rec['fits_80gb']}")
    return {"trace_s": rec["trace_s"], "total_gb": total,
            "fits_80gb": rec["fits_80gb"]}


def dry_run(dev):
    """Phase 14; returns the (c) paths' launches per rank.  (a), (b), the
    one-rank reference and qwen1.5's meta record are made on a thread of
    this process while it waits for (c)'s ranks."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.dryrun import TEST_RANKS, zero_axes_for
    from repro_torch.launch.mesh import dims_for, spawn
    from repro_torch.models import Model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loop import make_train_step
    t0 = time.perf_counter()
    cfg, shape = p14_combo(*P14_GPT2)
    job = {"cfg": cfg, "shape": shape, "multi_pod": False,
           "schedule": None, "guards": True, "run_step": True,
           "audit": False, "device": "cuda",
           "zero_axes": zero_axes_for(cfg, dims_for(cfg), False)}
    host = {}

    def host_work():
        try:
            model = Model(cfg, device=dev)
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            batch = {k: torch.zeros((shape.global_batch, shape.seq_len),
                                    dtype=torch.int32, device=dev)
                     for k in ("tokens", "labels")}
            _, _, m = make_train_step(model, AdamWConfig())(
                params, adamw_init(params), batch)
            host["want"] = float(m["loss"])
            del model, params, m
            host["qrec"] = dryrun.dry_one(*P14_QWEN, False, dtype="float32",
                                          reduced=True, seq=64, batch_size=8,
                                          test_mesh=True)
            for i, (_, kw) in enumerate(P14_TRACES):
                host[i] = dryrun.dry_one(*kw)
            host["done"] = time.perf_counter()
        except BaseException as e:     # re-raised on the main thread
            host["error"] = e
    thread = threading.Thread(target=host_work)
    t_spawn = time.time()
    thread.start()
    try:
        ranks = spawn(_p14_rank, TEST_RANKS, job, backend="gloo",
                      device="cuda", timeout=300)
        t_back = time.time()
        t_c = time.perf_counter()
    finally:
        thread.join()
    if "error" in host:
        raise host["error"]
    want, qrec = host["want"], host["qrec"]
    losses = [r["gpt2"]["step_metrics"]["loss"] for r in ranks]
    bad = [i for i, r in enumerate(ranks)
           if abs(r["gpt2"]["step_metrics"]["loss"] - want) > 1e-4
           or r["gpt2"]["step_metrics"]["nonfinite"] != 0.0
           or not r["zero_equal"]
           or r["moment_bytes"] != qrec["memory_analysis"]["moments_bytes"]
           or r["gpt2"]["launches"]["flash_attention"] <= 0
           or r["launches"]["rmsnorm"] <= 0
           or r["launches"]["flash_attention"] <= 0
           or sum(r["gpt2"]["launches"][k] for k in (
               "expert_ffn_grouped", "expert_ffn", "expert_ffn_ragged")) <= 0]
    if bad:
        raise AssertionError(f"phase 14 (c): ranks {bad}: losses {losses} "
                             f"vs one rank {want}, {ranks}")
    log(f"  (c) 8 gloo ranks on the card (4x2): gpt2-moe guarded --run-step "
        f"loss {losses[0]:.6f} (one rank {want:.6f}, nonfinite 0), "
        f"qwen1.5-0.5b ZeRO-1 over data torch.equal the whole-moment step on "
        f"every rank, moments {ranks[0]['moment_bytes']} bytes a rank (meta "
        f"record {qrec['memory_analysis']['moments_bytes']}) in "
        f"{t_c - t0:.1f} s: the ranks entered "
        f"{min(r['clock'][0] for r in ranks) - t_spawn:.1f}-"
        f"{max(r['clock'][0] for r in ranks) - t_spawn:.1f} s after the "
        f"spawn, gpt2-moe took "
        f"{max(r['clock'][1] - r['clock'][0] for r in ranks):.1f} s, "
        f"qwen1.5's two steps "
        f"{max(r['clock'][2] - r['clock'][1] for r in ranks):.1f} s, "
        f"schedule_comparison "
        f"{max(r['clock'][3] - r['clock'][2] for r in ranks):.1f} s, the "
        f"spawn returned {t_back - max(r['clock'][3] for r in ranks):.1f} s "
        f"after the last rank; the host work ended "
        f"{host['done'] - t_c:+.1f} s from (c)'s end")
    _p14_comparison(ranks, dev)
    for i, (label, _) in enumerate(P14_TRACES):
        _p14_report(label, host[i])
    names = sorted(ranks[0]["launches"])
    return {"dryrun_4x2_gpt2_moe": {
                k: [r["gpt2"]["launches"][k] for r in ranks] for k in names},
            "dryrun_4x2_qwen1.5_zero1": {
                k: [r["launches"][k] for r in ranks] for k in names},
            "comparison_4x2": {
                k: [r["comparison_launches"][k] for r in ranks]
                for k in names}}


def _p14_resolved(row) -> str:
    """A schedule_comparison row's schedule, ``auto``'s as its decision
    line names it (``... -> s2h x1 chunks ...``)."""
    if row["schedule"] != "auto":
        return row["schedule"]
    return re.search(r"-> (\S+) x\d+ chunks", row["decision"]).group(1)


def _p14_comparison(ranks, dev):
    """(c)'s schedule_comparison rows: rank 0's table logged; on every
    rank each closed-form row's collectives held to the paper's Eq. 1 / 11
    / 14 (``check_volumes``), ``max|y - y_base|`` as
    ``P14_COMPARISON_EXACT`` / ``_ATOL`` say, and the rows' kernels
    launched.  Then the gate's logits over one MP rank's half of a data
    rank's pool against the same rows of the product over the whole pool,
    on the card."""
    import torch
    from repro_torch.examples import schedule_comparison as sc
    from repro_torch.parallel.mesh import Mesh
    rows = ranks[0]["comparison"]
    log(f"  (c) schedule_comparison on the 8 ranks (4x2), d_model 256, "
        f"x (8, 512, 256), {P14_COMPARISON_ITERS} timed calls a row; rank "
        f"0 (gloo through the host):")
    for row in rows:
        nbytes, counts = sc.totals(row["volumes"])
        log(f"      {row['label']:10s} coll bytes {nbytes:9d} {counts} "
            f"{row['ms']:8.2f} ms/call  max|y-y_base| {row['err']:.2e}"
            + (f"  [{row['decision']}]" if row["decision"] else ""))
    held, bad = None, []
    for r, rank in enumerate(ranks):
        lines = check_volumes(rank["comparison"],
                              Mesh(sc.SHAPE, sc.NAMES, r), sc.DIMS, 8 * 512,
                              sc.layer_config())
        held = held or lines
        if any(row["err"] != 0.0
               if _p14_resolved(row) in P14_COMPARISON_EXACT
               else not row["err"] <= P14_COMPARISON_ATOL
               for row in rank["comparison"]) or any(
                rank["comparison_launches"][k] <= 0
                for k in P14_COMPARISON_USES):
            bad.append(r)
    if bad:
        raise AssertionError(f"phase 14 (c) schedule_comparison: ranks "
                             f"{bad}: {[ranks[r]['comparison'] for r in bad]}"
                             f" launches {[ranks[r]['comparison_launches'] for r in bad]}")
    for line in held:
        log(f"      {line}")
    log(f"      VOLUMES OK on every rank (Eq. 1, 11, 14; the aux means and "
        f"s1_seqpar's output gather beside the plan); launches a rank "
        f"{ {k: v for k, v in ranks[0]['comparison_launches'].items() if v} }")
    cfg = sc.layer_config()
    g = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((2 * 512, cfg.d_model), generator=g, device=dev)
    wg = torch.randn((cfg.d_model, cfg.n_experts), generator=g,
                     device=dev) * cfg.d_model ** -0.5
    d = float((x[:512] @ wg - (x @ wg)[:512]).abs().max())
    log(f"      rows {[r['label'] for r in rows if r['err'] == 0.0]} give the "
        f"baseline's bits on every rank; the gate's logits over 512 rows "
        f"(one MP rank's half of a data rank's pool) against the same rows "
        f"of the 1024-row product on {dev.type}: max |d| {d:.3e}")

# --- phase 15: the recurrent zoo -------------------------------------------

#: the two recurrent configs, each served at its full size: each path's
#: tag, its training steps and their learning rate, every step on one batch
#: (``train``'s ``one_batch``: at 2048 tokens the batches' losses spread
#: by ~0.03 nats, as much as xlstm's first steps move it), and the depth it
#: trains at (None: whole).  The first step is not taken twice here
#: (``repeat``): xlstm's step is bound by the sLSTM loop on the host, ~15 s
#: at 24 layers, so it trains at 8, one ``[mlstm x 7, slstm]`` group (a
#: third of the sLSTM steps), paying for phase 16
RZOO = (("hymba-1.5b", "hymba", 3, 1e-4, None),
        ("xlstm-350m", "xlstm", 2, 1e-3, 8))
#: serving: rows, prompt tokens fed through ``decode_step``, greedy tokens
#: through ``make_serve_step``
RZOO_ROWS, RZOO_PROMPT, RZOO_GEN = 8, 64, 32
#: every decode step's logits against ``Model.forward`` over the same
#: tokens, of the logits' scale: f32 sums in other orders over 24-32
#: layers, the recurrences stepped where the forward scans by chunk
RZOO_TOL = 1e-3
P15_LIMIT_S = 75.0


def rzoo_launches(cfg, decode=False):
    """Each kernel's predicted launches in one training step (the forward
    and remat's second forward run the kernels; their backward is the plain
    recompute) or in one decode step: ``rmsnorm`` for every norm of a
    layer (hymba 4, an mLSTM 1, an sLSTM 1 without FFN) and the final one,
    ``flash_attention`` once a hymba layer's forward (decode attention is
    plain code, as in JAX)."""
    from repro_torch.models.blocks import base_kind
    norms = {"hymba": 4, "mlstm": 1, "slstm": 1 if not cfg.d_ff else 2}
    per = 1 if decode else 2
    n_norm = sum(norms[base_kind(k)] * n for k, n in cfg.runs())
    n_attn = sum(n for k, n in cfg.runs() if base_kind(k) == "hymba")
    return {"rmsnorm": per * n_norm + 1,
            "flash_attention": 0 if decode else 2 * n_attn,
            "expert_ffn_grouped": 0, "moe_dispatch": 0}


def rzoo_serve(model, params, dev, want_launch=None, ctx=None, phase=15):
    """``RZOO_ROWS`` rows: ``RZOO_PROMPT`` prompt tokens through
    ``decode_step``, then ``RZOO_GEN`` greedy ``make_serve_step`` steps, the
    launches counted over both; every step's logits against
    ``Model.forward`` over the prompt and the greedy tokens (``RZOO_TOL``),
    the same greedy tokens.  The launches must be ``want_launch`` (default:
    ``rzoo_launches`` a decode step).  With ``ctx`` (the rows' context
    embeddings) ``Model.ctx_kv`` runs once inside the counted window (the
    encoder's launches are the path's) and every step takes its K/V.
    Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.train import make_serve_step
    cfg = model.cfg
    B, P, G = RZOO_ROWS, RZOO_PROMPT, RZOO_GEN
    n_steps = P + G
    if want_launch is None:
        want_launch = {k: v * n_steps for k, v in rzoo_launches(
            cfg, decode=True).items()}
    toks = torch.from_numpy(np.random.RandomState(151).randint(
        0, cfg.vocab_size, (B, P))).to(dev)
    tap = _LogitsTap(model)
    serve_step = make_serve_step(tap)
    cache = model.init_cache(B, P + G)
    batch = {} if ctx is None else {"ctx_embeds": ctx}
    wrappers = reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        kv = model.ctx_kv(params, batch)
        torch.cuda.synchronize()
        t_ctx = time.perf_counter() - t0
        for t in range(P):
            tap.decode_step(params, cache, {"tokens": toks[:, t:t + 1],
                                            "step": t}, ctx_kv=kv)
        torch.cuda.synchronize()
        t_prompt = time.perf_counter() - t0 - t_ctx
        tok = tap.seen[-1].argmax(-1).to(torch.int32)[:, None]
        stream = [tok]
        t0 = time.perf_counter()
        for t in range(P, P + G):
            tok, cache = serve_step(params, cache, {"tokens": tok,
                                                    "step": t}, kv)
            stream.append(tok)
        torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = read_counts(wrappers)
    if any(launches[k] != v for k, v in want_launch.items()):
        raise AssertionError(f"phase {phase} {cfg.name} serving: launches "
                             f"{launches}, predicted {want_launch}")
    stream = torch.cat(stream, 1).long()
    got = torch.stack(tap.seen, 1)                       # (B, P + G, V)
    full = torch.cat([toks, stream[:, :-1]], 1)
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": full, **batch})
    err = compare(f"phase {phase} {cfg.name}: decode logits vs "
                  f"Model.forward", got, want, RZOO_TOL)
    scale = max(1.0, want.abs().max().item())
    if not torch.equal(want[:, P - 1:].argmax(-1), stream):
        raise AssertionError(f"phase {phase} {cfg.name}: greedy tokens "
                             "differ between the serve steps and "
                             "Model.forward")
    kv_gb = 0.0 if kv is None else sum(
        t.numel() * t.element_size() for t in _leaves(kv)) / 1e9
    del got, want, cache, kv
    log(f"    serving {B} rows: "
        + ("" if ctx is None else f"ctx_kv over {tuple(ctx.shape)} in "
           f"{t_ctx:.3f} s ({kv_gb:.3f} GB of K/V), ")
        + f"{P} prompt tokens through decode_step in "
        f"{t_prompt:.3f} s ({B * P / t_prompt:.1f} tok/s), {G} greedy "
        f"make_serve_step steps in {t_gen:.3f} s ({B * G / t_gen:.1f} "
        f"tok/s, {t_gen / G * 1e3:.2f} ms a step); every step's "
        f"logits vs Model.forward max_abs_err {err:.3e} (tol {RZOO_TOL:g} "
        f"* {scale:.3g}), greedy tokens equal; launches "
        f"{({k: v for k, v in launches.items() if v})}")
    return launches


def slstm_share(cfg, dev, step_ms):
    """The share of one training step (``step_ms``) spent in the sLSTM
    layers: one sLSTM layer's forward under remat and its backward (the
    recompute, then the plain backward) at 1 x 2048, timed once on the
    host clock after the training steps (nothing left to warm up), times
    the sLSTM layers.  Returns (layer ms, share)."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import Model
    from repro_torch.models.model import layer_view
    model = Model(cfg, device=dev)
    r = next(i for i, (k, _) in enumerate(model.runs) if k == "slstm")
    n_slstm = sum(n for k, n in model.runs if k == "slstm")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    p = layer_view(params[f"run{r}"], 0)
    for t in p["slstm"].values():
        t.requires_grad_(True)
    x = torch.randn((1, 2048, cfg.d_model), device=dev, requires_grad=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, _, _ = checkpoint(model._layer, p, "slstm", x, None,
                         use_reentrant=False)
    y.sum().backward()
    torch.cuda.synchronize()
    layer_ms = (time.perf_counter() - t0) * 1e3
    del model, params, p, x, y
    torch.cuda.empty_cache()
    return layer_ms, n_slstm * layer_ms / step_ms


def recurrent_zoo(dev):
    """Phase 15 (see the module docstring).  Returns the launches of each
    serving and training path by kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from dataclasses import replace
    paths = {}
    for arch, tag, steps, lr, train_layers in RZOO:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        log(f"  {arch}: full size, {cfg.n_layers} layers {model.runs}: "
            f"{n_bytes / 1e9:.2f} GB of parameters made in "
            f"{time.perf_counter() - t0:.2f} s")
        paths[f"serve_{tag}"] = rzoo_serve(model, params, dev)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, params
        torch.cuda.empty_cache()
        if train_layers:
            cfg = replace(cfg, n_layers=train_layers)
        per_step = rzoo_launches(cfg)
        uses = tuple(k for k in ("rmsnorm", "flash_attention")
                     if per_step[k])
        launches, step_ms = train(tag, cfg, dev, batch=1, seq=2048,
                                  steps=steps, lr=lr, uses=uses,
                                  per_step=per_step, with_ms=True,
                                  repeat=False, one_batch=True)
        paths[f"train_{tag}"] = launches
        peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
        if any(k == "slstm" for k, _ in cfg.runs()):
            layer_ms, share = slstm_share(cfg, dev, step_ms)
            log(f"    one sLSTM layer's forward and backward at 1 x 2048: "
                f"{layer_ms:.1f} ms (host clock); the sLSTM layers' share "
                f"of the step: {share:.3f}")
        log(f"    {arch} in {time.perf_counter() - t0:.1f} s, peak device "
            f"memory {peak:.2f} GB")
    return paths


# --- phase 16: the cross-attention zoo --------------------------------------

#: each config, its path tag, its training rows x tokens and learning rate:
#: llama-3.2-vision at 1 x 2048 at 1e-5 (at qwen3's 1e-4 Adam's first,
#: sign-like step raised the loss, 12.2229 -> 12.5497, before it fell),
#: whisper-tiny over Whisper's text context, 8 x 448, at gpt2-moe's 1e-3
#: (a 36.5M-parameter model)
XZOO = (("llama-3.2-vision-11b", "llama_vision", (1, 2048), 1e-5),
        ("whisper-tiny", "whisper", (8, 448), 1e-3))
#: llama-3.2-vision trains at full width cut to this depth: 4 dense layers
#: and the first cross layer (16 bytes a parameter with AdamW: 162 GB at 40
#: layers, 69.9 GB at 10, 34.9 GB at 5); it serves at its 40
XZOO_TRAIN_LAYERS = 5
XZOO_STEPS = 3
#: the train launcher on whisper-tiny: the data pipeline's batches, no
#: ``ctx_embeds``, as JAX's launcher feeds them
XZOO_LAUNCHER = ("--arch", "whisper-tiny", "--steps", "2", "--seq", "448",
                 "--batch", "8")
P16_LIMIT_S = 75.0


def xzoo_launches(cfg, decode=False):
    """Each kernel's predicted launches in one training step over a context
    (the forward and remat's second forward run the kernels, their
    backward is the plain recompute; whisper's encoder runs once, outside
    remat, as JAX's scan runs it) or in one decode step: ``rmsnorm`` for
    every norm a layer reads (a dense layer 2, a cross layer 2: its
    ``norm2`` is never read) and the final one, none under layernorm
    (whisper); ``flash_attention`` once a self-attention a forward (the
    dense layers', the ``xdec`` and encoder layers'); cross attention over
    a context and decode attention are plain code, as in JAX."""
    from repro_torch.models.blocks import base_kind
    per = 1 if decode else 2
    norms = {"dense": 2, "cross": 2, "xdec": 3}
    n_norm = sum(norms[base_kind(k)] * n for k, n in cfg.runs())
    n_self = sum(n for k, n in cfg.runs()
                 if base_kind(k) in ("dense", "xdec"))
    enc = cfg.encoder_layers if cfg.arch_type == "audio" else 0
    return {"rmsnorm": per * n_norm + 1 if cfg.norm_type == "rmsnorm"
            else 0,
            "flash_attention": 0 if decode else 2 * n_self + enc,
            "expert_ffn_grouped": 0, "moe_dispatch": 0}


def whisper_launcher(dev):
    """``XZOO_LAUNCHER`` through ``launch.train.main`` in this process: no
    context, so each ``xdec`` layer's ``xattn`` attends the text itself,
    unmasked (JAX's ``Trainer`` does the same): per step 2 causal and 2
    non-causal flash launches a layer (the forward and remat's second
    one; 8 and 8 over whisper's 4), the non-causal ones counted by a
    wrapper around the registry's op; layernorm, so no rmsnorm.  Every
    logged loss finite.  Returns the launches."""
    import tempfile

    from repro_torch.kernels import registry
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train as launcher
    noncausal = [0]

    def counted(q, k, v, *, causal=True, window=None, scale=None):
        n0 = flash_attention.launches
        out = flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale)
        if not causal:
            noncausal[0] += flash_attention.launches - n0
        return out

    steps = int(XZOO_LAUNCHER[XZOO_LAUNCHER.index("--steps") + 1])
    per_kind = 2 * launcher.get_config("whisper-tiny").n_layers * steps
    saved = registry._OPS["flash_attention"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "log.json")
        registry._OPS["flash_attention"] = counted
        wrappers = reset_counts()
        t0 = time.perf_counter()
        try:
            launcher.main([*XZOO_LAUNCHER, "--log-json", path])
        finally:
            registry._OPS["flash_attention"] = saved
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        with open(path) as f:
            hist = json.load(f)
    want = {"flash_attention": 2 * per_kind, "rmsnorm": 0}
    if any(launches[k] != v for k, v in want.items()) or \
            noncausal[0] != per_kind:
        raise AssertionError(f"phase 16 launcher: launches {launches}, "
                             f"{noncausal[0]} non-causal; predicted {want}, "
                             f"{per_kind} non-causal")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 16 launcher: losses {losses}")
    log(f"    launcher {' '.join(XZOO_LAUNCHER)}: {wall:.2f} s, losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; flash "
        f"{launches['flash_attention']} launches, {noncausal[0]} of them "
        f"non-causal (its first main-path launches)")
    return launches


def cross_zoo(dev):
    """Phase 16 (see the module docstring).  Returns the launches of each
    serving and training path by kernel."""
    from dataclasses import replace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    g = torch.Generator(device=dev).manual_seed(16)

    def context(cfg, rows):
        n = cfg.n_ctx_tokens if cfg.arch_type == "vlm" else cfg.encoder_seq
        return torch.randn((rows, n, cfg.d_model), generator=g, device=dev)

    paths = {}
    for arch, tag, (rows, seq), lr in XZOO:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        torch.cuda.reset_peak_memory_stats()
        model = Model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        set_gates(model, params)
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        log(f"  {arch}: full size, {cfg.n_layers} layers {model.runs}"
            + (f", encoder {cfg.encoder_layers} layers" if
               model.has_encoder else "")
            + f": {n_bytes / 1e9:.2f} GB of parameters made in "
            f"{time.perf_counter() - t0:.2f} s, gates {XZOO_GATES}")
        n_steps = RZOO_PROMPT + RZOO_GEN
        want = {k: v * n_steps
                for k, v in xzoo_launches(cfg, decode=True).items()}
        want["flash_attention"] = cfg.encoder_layers \
            if model.has_encoder else 0
        paths[f"serve_{tag}"] = rzoo_serve(
            model, params, dev, want, context(cfg, RZOO_ROWS), phase=16)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del model, params
        torch.cuda.empty_cache()
        if cfg.arch_type == "vlm":
            cfg = replace(cfg, n_layers=XZOO_TRAIN_LAYERS)
        per_step = xzoo_launches(cfg)
        uses = tuple(k for k in ("rmsnorm", "flash_attention")
                     if per_step[k])
        paths[f"train_{tag}"] = train(
            tag, cfg, dev, batch=rows, seq=seq, steps=XZOO_STEPS, lr=lr,
            uses=uses, per_step=per_step, repeat=False, one_batch=True,
            ctx=context(cfg, rows))
        peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
        log(f"    {arch} in {time.perf_counter() - t0:.1f} s, peak device "
            f"memory {peak:.2f} GB")
    paths["launcher_whisper"] = whisper_launcher(dev)
    return paths


# --- phase 17: the examples and bert-moe -----------------------------------

#: the phase's stated limit, seconds (logged beside its time)
P17_LIMIT_S = 60.0
#: the quickstart's steps (the example's own 60) and train_100m's (its
#: command line's default is 300; 30 show the cross-entropy falling)
P17_QUICKSTART_STEPS = 60
P17_100M_STEPS = 30
#: bert-moe (the paper's Table V BERT-Base-MoE) trained whole: batch,
#: sequence, steps and learning rate (gpt2-moe's of phase 8); served
#: through the paged engine with phase 4's requests
P17_BERT = dict(batch=8, seq=512, steps=5, lr=1e-3)
P17_BERT_GEN = 32
#: each path's kernels and their launches, exactly: per step of training
#: (the quickstart's reduced qwen3, 2 layers: 2 rmsnorm a layer + 1, one
#: flash and one grouped launch a layer; train_100m's 8 layers, 4 of them
#: MoE; bert-moe's 12 layers, 6 MoE, remat on: each block's forward twice)
#: and in all of serve_batched's 4 x 24 decode steps (rmsnorm 2 a layer + 1
#: a step of qwen1.5's and qwen3's, ``rzoo_launches``' of xlstm's and
#: hymba's, the grouped kernel a step of qwen3's 2 MoE layers; decode
#: attention is plain code, as in JAX)
P17_USES = {
    "example_quickstart": {"rmsnorm": 5, "flash_attention": 2,
                           "expert_ffn_grouped": 2},
    "example_train_100m": {"flash_attention": 8, "expert_ffn_grouped": 4},
    "train_bert_moe": {"flash_attention": 24, "expert_ffn_grouped": 12},
}


def examples(dev):
    """Phase 17 (see the module docstring).  Returns the launches of each
    path by kernel."""
    import types

    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples import quickstart, serve_batched, train_100m
    from repro_torch.models import Model
    paths = {}
    none = {k: 0 for k in kernel_wrappers()}

    def want_exact(path, launches, steps):
        want = dict(none, **{k: v * steps for k, v in
                             P17_USES[path].items()})
        if launches != want:
            raise AssertionError(f"phase 17 {path}: launches {launches}, "
                                 f"predicted {want}")

    # (a) the quickstart: Algorithm 1's pick, 60 steps under auto
    t0 = time.perf_counter()
    wrappers = reset_counts()
    hist = quickstart.run(types.SimpleNamespace(steps=P17_QUICKSTART_STEPS),
                          dev)
    torch.cuda.synchronize()
    paths["example_quickstart"] = read_counts(wrappers)
    losses = [h["loss"] for h in hist]
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise AssertionError(f"phase 17 (a): losses {losses}")
    want_exact("example_quickstart", paths["example_quickstart"],
               P17_QUICKSTART_STEPS)
    step_ms = ((hist[-1]["wall_s"] - hist[0]["wall_s"])
               / (hist[-1]["step"] - hist[0]["step"]) * 1e3)
    log(f"  (a) quickstart: {P17_QUICKSTART_STEPS} steps of 8 x 64 tokens, "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, {step_ms:.1f} ms/step "
        f"after the first; {time.perf_counter() - t0:.1f} s")

    # (b) serve_batched: four reduced archs, 4 rows x 24 greedy tokens,
    # then each again through the plain versions on the same weights
    t0 = time.perf_counter()
    wrappers = reset_counts()
    served = {name: serve_batched.serve(name, dev)
              for name in serve_batched.ARCHS}
    torch.cuda.synchronize()
    got = paths["example_serve_batched"] = read_counts(wrappers)
    for name, toks in served.items():
        vocab = get_config(name).reduced().vocab_size
        if len(toks) != 24 or not all(
                len(row) == 4 and all(0 <= t < vocab for t in row)
                for row in toks):
            raise AssertionError(f"phase 17 (b) {name}: tokens {toks}")
        with plain_ops(), contextlib.redirect_stdout(io.StringIO()):
            plain = serve_batched.serve(name, dev)
        if plain != toks:
            raise AssertionError(f"phase 17 (b) {name}: tokens {toks}, "
                                 f"the plain versions' {plain}")
    n_rms = 24 * sum(
        rzoo_launches(c, decode=True)["rmsnorm"] if c.arch_type in (
            "hybrid", "ssm") else 2 * c.n_layers + 1
        for c in (get_config(n).reduced() for n in serve_batched.ARCHS))
    q3 = get_config("qwen3-moe-30b-a3b").reduced()
    want = dict(none, rmsnorm=n_rms, expert_ffn_grouped=24 * sum(
        n for kind, n in q3.runs() if "moe" in kind))
    if got != want:
        raise AssertionError(f"phase 17 (b): launches {got}, predicted "
                             f"{want}")
    log(f"  (b) serve_batched in {time.perf_counter() - t0:.1f} s, every "
        f"token equal to the plain versions' on the same weights")

    # (c) train_100m at full width (the cross-entropy must fall)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    wrappers = reset_counts()
    hist = train_100m.train(dev, P17_100M_STEPS)
    torch.cuda.synchronize()
    paths["example_train_100m"] = read_counts(wrappers)
    want_exact("example_train_100m", paths["example_train_100m"],
               P17_100M_STEPS)
    step_ms = ((hist[-1]["wall_s"] - hist[0]["wall_s"])
               / (hist[-1]["step"] - hist[0]["step"]) * 1e3)
    log(f"  (c) train_100m: {P17_100M_STEPS} steps of 8 x 256 tokens, CE "
        f"{hist[0]['ce']:.4f} -> {hist[-1]['ce']:.4f}, {step_ms:.1f} "
        f"ms/step after the first, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (d) bert-moe trained whole: kernels vs plain versions, then AdamW
    # steps (the first step's repeat, bitwise, is phases 7 and 8's: the
    # same blocks, layernorm and MoE code on gpt2-moe)
    t0 = time.perf_counter()
    cfg = get_config("bert-moe")
    b = P17_BERT
    paths["train_bert_moe"], bert_ms = train(
        "bert-moe", cfg, dev, batch=b["batch"], seq=b["seq"],
        steps=b["steps"], lr=b["lr"],
        uses=tuple(P17_USES["train_bert_moe"]),
        per_step=dict(none, **P17_USES["train_bert_moe"]), with_ms=True,
        repeat=False)
    log(f"  (d) bert-moe trained in {time.perf_counter() - t0:.1f} s "
        f"({bert_ms:.1f} ms/step)")

    # (e) bert-moe served through the paged engine
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompts = make_requests(cfg.vocab_size)
    err = reference_check(model, params, prompts[0])
    serve(model, params, prompts[:2], gen=4)          # warm-up (not counted)
    wrappers = reset_counts()
    done, eng, wall = serve(model, params, prompts, gen=P17_BERT_GEN)
    launches = paths["serve_bert_moe"] = read_counts(wrappers)
    serve_report("bert-moe", done, eng, wall, len(prompts), P17_BERT_GEN)
    if launches["expert_ffn_grouped"] <= 0 or any(
            v for k, v in launches.items() if k != "expert_ffn_grouped"):
        raise AssertionError(f"phase 17 (e): launches {launches}")
    log(f"  (e) bert-moe served: paged_step logits kernels vs plain "
        f"max_abs_err {err:.3e}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"{time.perf_counter() - t0:.1f} s")
    del model, params, eng, done
    torch.cuda.empty_cache()
    return paths


#: the phases, and the ones each needs to have run before it (their model,
#: prompts, reference runs or launch counts); 1 and 2 (the card, the
#: build) always run, and 18 (the kernels line) only when every phase did
PHASES = tuple(range(1, 19))
PHASE_NEEDS = {5: (4,), 9: (7, 8), 10: (4, 5, 6), 11: (4, 6), 18: PHASES[:17]}


def parse_phases(argv=None) -> set:
    """The phases to run, from ``--phases 1,2,12`` (default: every phase):
    the named ones, the phases they need (``PHASE_NEEDS``, transitively),
    and 1 and 2."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="chip_smoke.py", description="On-card smoke of the port; "
        "with no arguments every phase runs once.")
    ap.add_argument("--phases", default=",".join(map(str, PHASES)),
                    help="comma-separated phase numbers, e.g. 1,2,12")
    args = ap.parse_args(argv)
    try:
        want = {int(p) for p in args.phases.split(",") if p.strip()}
    except ValueError:
        ap.error(f"--phases {args.phases!r}: want numbers like 1,2,12")
    bad = sorted(want - set(PHASES))
    if bad or not want:
        ap.error(f"--phases {args.phases!r}: phases are {PHASES[0]}.."
                 f"{PHASES[-1]}")
    todo, out = list(want | {1, 2}), set()
    while todo:
        p = todo.pop()
        if p not in out:
            out.add(p)
            todo.extend(PHASE_NEEDS.get(p, ()))
    return out


#: kernel -> (source, the TPU kernel it replaces, its main path, the phase-3
#: row at that path's shapes)
KERNELS = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:12", "train_qwen3",
                "train-qwen3"),
    "expert_ffn_grouped": ("src/repro_torch/csrc/expert_ffn_grouped.cu",
                           "src/repro/kernels/expert_ffn_grouped.py:136",
                           "train_qwen3", "train-qwen3"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:28",
                        "train_qwen3", "qwen3"),
    "moe_dispatch": ("src/repro_torch/csrc/moe_dispatch.cu",
                     "src/repro/kernels/moe_dispatch.py:22",
                     "train_gpt2_moe_s1_pipe2", "train-gpt2-moe"),
    "moe_combine": ("src/repro_torch/csrc/moe_dispatch.cu",
                    "src/repro/kernels/moe_dispatch.py:72",
                    "train_gpt2_moe_s1_pipe2", "train-gpt2-moe"),
    "expert_ffn": ("src/repro_torch/csrc/expert_ffn.cu",
                   "src/repro/kernels/expert_ffn.py:25",
                   "train_gpt2_moe_s1_pipe2", "train-gpt2-moe-chunk"),
    "expert_ffn_ragged": ("src/repro_torch/csrc/expert_ffn.cu",
                          "src/repro/kernels/expert_ffn_grouped.py:41",
                          "train_qwen3_s1g_fp8", "train-qwen3-fp8"),
}

#: (kernel, path) -> the phase-3 row at the shapes that path gives the
#: kernel (serving: decode, the shape of most of its launches); a pair not
#: listed must launch the kernel no time on that path
SHAPE_OF = {
    ("rmsnorm", "serve_one_shot"): "decode",
    ("rmsnorm", "serve_chunked_32"): "decode",
    ("rmsnorm", "serve_one_shot_s1d"): "decode",
    ("rmsnorm", "train_qwen3"): "train-qwen3",
    ("rmsnorm", "train_qwen3_s1g_fp8"): "train-qwen3",
    ("expert_ffn_grouped", "serve_one_shot"): "decode",
    ("expert_ffn_grouped", "serve_chunked_32"): "decode",
    ("expert_ffn_grouped", "train_qwen3"): "train-qwen3",
    ("expert_ffn_grouped", "train_gpt2_moe"): "train-gpt2-moe",
    ("flash_attention", "train_qwen3"): "qwen3",
    ("flash_attention", "train_qwen3_s1g_fp8"): "qwen3",
    ("flash_attention", "train_gpt2_moe"): "gpt2-moe",
    ("flash_attention", "train_gpt2_moe_s1_pipe2"): "gpt2-moe",
    ("moe_dispatch", "serve_one_shot_s1d"): "decode",
    ("moe_dispatch", "train_qwen3_s1g_fp8"): "train-qwen3",
    ("moe_dispatch", "train_gpt2_moe_s1_pipe2"): "train-gpt2-moe",
    ("moe_combine", "serve_one_shot_s1d"): "decode",
    ("moe_combine", "train_qwen3_s1g_fp8"): "train-qwen3",
    ("moe_combine", "train_gpt2_moe_s1_pipe2"): "train-gpt2-moe",
    ("expert_ffn", "serve_one_shot_s1d"): "decode",
    ("expert_ffn", "train_gpt2_moe_s1_pipe2"): "train-gpt2-moe-chunk",
    ("expert_ffn_ragged", "train_qwen3_s1g_fp8"): "train-qwen3-fp8",
}
SHAPE_OF.update({
    ("rmsnorm", "serve_chaos"): "decode",
    ("expert_ffn_grouped", "serve_chaos"): "decode",
    ("moe_dispatch", "trace_gpt2_moe_s1"): "train-gpt2-moe",
    ("moe_combine", "trace_gpt2_moe_s1"): "train-gpt2-moe",
    ("expert_ffn", "trace_gpt2_moe_s1"): "train-gpt2-moe",
    ("expert_ffn_grouped", "trace_gpt2_moe_s1g"): "train-gpt2-moe"})
# phase 11: every measured calibration runs s1g (the grouped kernel) and
# the dispatch -> expert_ffn -> combine schedules; (d) trains with flash,
# (e) serves with rmsnorm
for _path, _label in (("autosched_measure_gpt2_moe", "train-gpt2-moe"),
                      ("autosched_measure_qwen3_train", "train-qwen3"),
                      ("autosched_measure_qwen3_decode", "decode"),
                      ("train_gpt2_moe_measured", "train-gpt2-moe"),
                      ("serve_measured", "decode")):
    SHAPE_OF.update({(k, _path): _label for k in (
        "moe_dispatch", "moe_combine", "expert_ffn", "expert_ffn_grouped")})
SHAPE_OF[("flash_attention", "train_gpt2_moe_measured")] = "gpt2-moe"
# phase 13: decode rows at each config's width (llama4's serving under
# auto and chunked runs s1g, the grouped kernel; under s1d dispatch ->
# expert_ffn -> combine), qwen1.5's training step; command-r launches none
for _path in ("serve_llama4_one_shot", "serve_llama4_chunked_32",
              "serve_llama4_one_shot_s1d", "serve_mistral_nemo"):
    SHAPE_OF[("rmsnorm", _path)] = "decode-5120"
for _path in ("serve_llama4_one_shot", "serve_llama4_chunked_32"):
    SHAPE_OF[("expert_ffn_grouped", _path)] = "decode-llama4"
SHAPE_OF.update({(k, "serve_llama4_one_shot_s1d"): "decode-llama4" for k in (
    "moe_dispatch", "moe_combine", "expert_ffn")})
SHAPE_OF.update({("rmsnorm", "serve_yi_9b"): "decode-4096",
                 ("rmsnorm", "serve_qwen1_5"): "decode-1024",
                 ("rmsnorm", "train_qwen1_5"): "train-qwen1.5",
                 ("flash_attention", "train_qwen1_5"): "qwen1.5"})
SHAPE_OF[("rmsnorm", "serve_measured")] = "decode"
# phase 13 (c): the KV-cache path's one prefill_step at 4 x 2048 (flash's
# serving launches) and its 33 calls of rmsnorm, 32 of them decode rows
SHAPE_OF.update({("flash_attention", "serve_mistral_nemo_cache"):
                 "mistral-nemo-prefill",
                 ("rmsnorm", "serve_mistral_nemo_cache"): "decode-5120"})
# phase 15: hymba's training step (flash with its window and group of 5,
# rmsnorm at 1600) and decode rows; xlstm's at 1024 (qwen1.5's shapes)
SHAPE_OF.update({("rmsnorm", "train_hymba"): "train-hymba",
                 ("flash_attention", "train_hymba"): "hymba",
                 ("rmsnorm", "serve_hymba"): "decode-1600",
                 ("rmsnorm", "train_xlstm"): "train-qwen1.5",
                 ("rmsnorm", "serve_xlstm"): "decode-1024"})
# phase 16: llama-3.2-vision's decode rows (yi's width) and training step;
# whisper's encoder in ``ctx_kv`` (its serving's only launches), its
# training step (most launches the decoder's 8 x 448) and the launcher's
# (half of them non-causal, the rest at the same shape causal)
SHAPE_OF.update({("rmsnorm", "serve_llama_vision"): "decode-4096",
                 ("rmsnorm", "train_llama_vision"): "train-4096",
                 ("flash_attention", "train_llama_vision"): "llama-vision",
                 ("flash_attention", "serve_whisper"): "whisper-enc",
                 ("flash_attention", "train_whisper"): "whisper-dec",
                 ("flash_attention", "launcher_whisper"): "noncausal"})
# phase 12 (l): one rank of (2, 2), rank 0's launches (every rank's are
# checked equal): hymba's 1 x 2048 step at 1600 and every head's flash
# (the gathered-heads layout) as on one rank; xlstm's 1 x 512 at 1024;
# decode 8 rows a data rank
SHAPE_OF.update({("rmsnorm", "train_hymba_mesh"): "train-hymba",
                 ("flash_attention", "train_hymba_mesh"): "hymba",
                 ("rmsnorm", "decode_hymba_mesh"): "decode-1600",
                 ("rmsnorm", "train_xlstm_mesh"): "train-512x1024",
                 ("rmsnorm", "decode_xlstm_mesh"): "decode-1024"})
#: phase 12 (l)'s paths, in ``by_path`` with rank 0's launches
P12_RZOO_PATHS = tuple(f"{what}_{tag}_mesh" for _, tag, _, _, _ in P12_RZOO
                       for what in ("train", "decode"))
# phase 12 (m): one rank of (2, 2): llama-3.2-vision's 1 x 2048 step at
# 4096 wide with 16 / 4 heads a rank and its decode rows; whisper's flash
# at 3 heads a rank, its step's and ``ctx_kv``'s time the encoder's 8 x
# 1500 frames (4 launches of 0.24 ms against 8 of the decoder's 8 x 448 at
# ~0.04); layernorm, so no rmsnorm
SHAPE_OF.update({("rmsnorm", "train_vision_mesh"): "train-4096",
                 ("flash_attention", "train_vision_mesh"): "llama-vision-mp2",
                 ("rmsnorm", "decode_vision_mesh"): "decode-4096",
                 ("flash_attention", "train_whisper_mesh"): "whisper-enc-mp2",
                 ("flash_attention", "decode_whisper_mesh"):
                     "whisper-enc-mp2"})
# phase 17: the examples' reduced archs and full-width runs, bert-moe's
# training step and its decode rows (most of its serving's launches)
SHAPE_OF.update({("rmsnorm", "example_quickstart"): "train-quickstart",
                 ("flash_attention", "example_quickstart"): "quickstart",
                 ("expert_ffn_grouped", "example_quickstart"):
                     "train-quickstart",
                 ("rmsnorm", "example_serve_batched"): "decode-256",
                 ("expert_ffn_grouped", "example_serve_batched"):
                     "decode-quickstart",
                 ("flash_attention", "example_train_100m"): "train-100m",
                 ("expert_ffn_grouped", "example_train_100m"): "train-100m",
                 ("flash_attention", "train_bert_moe"): "bert-moe",
                 ("expert_ffn_grouped", "train_bert_moe"): "train-bert-moe",
                 ("expert_ffn_grouped", "serve_bert_moe"): "decode-bert-moe"})
#: phase 12 (m)'s paths, in ``by_path`` with rank 0's launches
P12_XZOO_PATHS = tuple(f"{what}_{tag}_mesh" for _, tag, _, _, _ in P12_XZOO
                       for what in ("train", "decode"))
#: (kernel, multi-rank path) -> the phase-3 row at the shapes one rank's
#: launches take there: phase 12 (k)'s prefill on one rank of (2, 2) (16 /
#: 4 heads; B=1 one row of 16384, B=2 one row of 2048 a data rank) and its
#: rmsnorm, mostly decode rows at 5120 wide
MULTI_SHAPE_OF = {}
for _name, _L in (("b1", "16k"), ("b2", "2k")):
    for _tag in ("heads", "seq"):
        MULTI_SHAPE_OF.update({
            ("flash_attention", f"kvcache_2x2_{_name}_{_tag}"):
                f"mistral-nemo-{_L}-rank",
            ("rmsnorm", f"kvcache_2x2_{_name}_{_tag}"): "decode-5120"})
# phase 9's two runs: the ragged path while the wire is fp8, the fused
# grouped kernel on the bf16 wire after the fallback
for _path in ("train_gpt2_moe_guarded_s1g_fp8", "train_gpt2_moe_fp8_fallback"):
    SHAPE_OF.update({
        ("flash_attention", _path): "gpt2-moe",
        ("moe_dispatch", _path): "train-gpt2-moe",
        ("moe_combine", _path): "train-gpt2-moe",
        ("expert_ffn_ragged", _path): "train-gpt2-moe-fp8",
        ("expert_ffn_grouped", _path): "train-gpt2-moe-wire-bf16"})


def main(argv=None) -> int:
    phases = parse_phases(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this smoke runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.core.collectives import CommConfig
    from repro_torch.kernels import _build
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    global _T_START
    t_start = _T_START = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"phase 2: built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    spilled = []
    for name, text in logs.items():
        fn = ""
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:  # the kernel's name and template arguments, mangled
                short = re.search(r"[a-z]+(?:_[a-z]+)*_kernel(?:I\w+?EE)?",
                                  entry.group(1))
                fn = short.group(0) if short else entry.group(1)[:56]
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  [{name}] {fn}: {line.strip()}")
            if name in NO_SPILL and any(
                    int(n) for n in re.findall(r"(\d+) bytes spill", line)):
                spilled.append(f"[{name}] {line.strip()}")
    if spilled:
        raise AssertionError("phase 2: the redesigned kernels spill: "
                             + "; ".join(spilled))

    # 3. kernels vs plain versions
    if 3 in phases:
        log("phase 3: kernels vs plain versions on the card")
        rows = {"rmsnorm": check_rmsnorm(dev),
                "expert_ffn_grouped": check_grouped(dev),
                "flash_attention": check_flash(dev)}
        rows["moe_dispatch"], rows["moe_combine"] = \
            check_dispatch_combine(dev)
        rows["expert_ffn"] = check_expert_ffn(dev)
        rows["expert_ffn_ragged"] = check_ragged(dev)
        check_codec(dev)
        torch.cuda.empty_cache()

    # 4. serve full width, 4 layers
    cfg = replace(get_config("qwen3-moe-30b-a3b"), n_layers=N_LAYERS)
    prompts = make_requests(cfg.vocab_size)
    gen = 32
    path_launches = {}
    forward_ms = None
    if 4 in phases:
        model = Model(cfg, device=dev)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(params))
        log(f"phase 4: {cfg.name} full width, {N_LAYERS} layers: "
            f"{n_bytes / 1e9:.2f} GB of parameters made on the card in "
            f"{time.perf_counter() - t0:.3f} s")
        serve(model, params, prompts[:2], gen=4)      # warm-up (not counted)
        for sched in (None, "s1d"):
            err_ref = reference_check(model, params, prompts[0], sched)
            log(f"  reference check ({sched or 'auto'}): paged_step logits, "
                f"kernels vs plain versions: max_abs_err {err_ref:.3e}")

        runs = {}
        for label, path, kw, uses in (
                ("one-shot", "serve_one_shot", {},
                 ("rmsnorm", "expert_ffn_grouped")),
                ("chunked-32", "serve_chunked_32", {"prefill_chunk": 32},
                 ("rmsnorm", "expert_ffn_grouped")),
                ("one-shot-s1d", "serve_one_shot_s1d", {"schedule": "s1d"},
                 ("rmsnorm", "moe_dispatch", "expert_ffn", "moe_combine"))):
            torch.cuda.reset_peak_memory_stats()
            wrappers = reset_counts()
            done, eng, wall = serve(model, params, prompts, gen=gen, **kw)
            launches = read_counts(wrappers)
            st = serve_report(label, done, eng, wall, len(prompts), gen)
            peak = torch.cuda.max_memory_allocated() / 1e9
            log(f"  {label}: peak device memory {peak:.2f} GB; launches "
                f"{ {k: v for k, v in launches.items() if v} }")
            if min(launches[name] for name in uses) <= 0:
                raise AssertionError(f"{label}: a kernel of the path was "
                                     f"never launched: {launches}")
            runs[label] = done
            path_launches[path] = launches
        # s1d runs dispatch -> expert_ffn -> combine, the grouped kernel's
        # FMA chains (phase 6 holds the two bitwise): the same tokens
        bad = [i for i in range(len(prompts))
               if runs["one-shot"][i].tokens != runs["one-shot-s1d"][i].tokens]
        if bad:
            raise AssertionError(f"phase 4: requests {bad} differ between "
                                 f"one-shot serving under auto and under s1d")
        log(f"  one-shot vs one-shot-s1d: {len(prompts)}/{len(prompts)} "
            f"requests with identical tokens")
        same = sum(runs["one-shot"][i].tokens == runs["chunked-32"][i].tokens
                   for i in range(len(prompts)))
        # prefill pools take the training capacity (infer=False), so which
        # rows drop depends on the chunking, in the JAX engine as here; at
        # capacity_factor = n_experts / top_k no pool can drop a row, and
        # chunked prefill must then give one-shot's tokens
        moe = cfg.moe
        free = Model(replace(cfg, moe=replace(
            moe, capacity_factor=moe.n_experts / moe.top_k)), device=dev)
        df = {label: serve(free, params, prompts, gen=gen, **kw)[0]
              for label, kw in (("one-shot", {}),
                                ("chunked-32", {"prefill_chunk": 32}))}
        bad = [i for i in range(len(prompts))
               if df["one-shot"][i].tokens != df["chunked-32"][i].tokens]
        if bad:
            raise AssertionError(f"phase 4: at drop-free capacity requests "
                                 f"{bad} differ between one-shot and chunked "
                                 f"prefill")
        log(f"  one-shot vs chunked-32: {same}/{len(prompts)} requests with "
            f"identical tokens at capacity_factor {moe.capacity_factor} (the "
            f"prefill pools' drops depend on the chunking, as in the JAX "
            f"engine); {len(prompts)}/{len(prompts)} at the drop-free "
            f"capacity_factor {moe.n_experts / moe.top_k:g}")
        del free, df

        if 5 in phases:
            # 5. determinism and batch independence
            fwd, _, _ = serve(model, params, prompts, gen=gen,
                              prefix_cache=False)
            rev, _, _ = serve(model, params, prompts, gen=gen,
                              prefix_cache=False,
                              order=range(len(prompts) - 1, -1, -1))
            bad = [i for i in range(len(prompts))
                   if fwd[i].tokens != rev[i].tokens]
            if bad:
                raise AssertionError(f"phase 5: requests {bad} differ between "
                                     f"forward and reversed arrival order")
            log(f"phase 5: {len(prompts)} requests, forward vs reversed "
                f"arrival order: identical greedy tokens")

            if 10 in phases:
                # 10. serving under faults and deadlines (the same model
                # and prompts; phase 5's forward run is the fault-free
                # reference)
                t0 = time.perf_counter()
                log("phase 10: serving under faults, deadlines and sheds; "
                    "telemetry")
                path_launches["serve_chaos"] = serve_robustness(
                    model, params, prompts, gen, fwd)
                log(f"  (a)-(e) in {time.perf_counter() - t0:.1f} s")

        if 11 in phases:
            # 11 (e). serving under the measured autoscheduler (the same
            # model and prompts; phase 4's one-shot run is the reference)
            t0 = time.perf_counter()
            log("phase 11 (e): serving under autosched=measured")
            path_launches["serve_measured"] = serve_measured(
                model, params, prompts, gen, runs["one-shot"])
            log(f"  (e) in {time.perf_counter() - t0:.1f} s")

        del model, params, runs, done, eng
        torch.cuda.empty_cache()

    if 6 in phases:
        # 6. the schedules on one rank, then (phase 10 (g)) the stage traces of
        # the same layer
        log("phase 6: one gpt2-moe MoE layer under every one-rank schedule")
        forward_ms = check_schedules(dev)
        torch.cuda.empty_cache()
        if 10 in phases:
            path_launches.update(stage_traces(dev, forward_ms))
            torch.cuda.empty_cache()

    if 7 in phases:
        # 7. and 8. train qwen3 (full width, 4 layers) and gpt2-moe (full
        # size), each under the default schedule and under this slice's path.
        # qwen3 at lr 1e-3 (gpt2-moe's) spikes from its router z-loss in the
        # first steps; at 1e-4 the loss falls step by step
        log(f"phase 7: train {cfg.name} full width, {N_LAYERS} layers")
        path_launches["train_qwen3"] = train(
            "qwen3", cfg, dev, batch=1, seq=2048, steps=10, lr=1e-4,
            uses=("rmsnorm", "flash_attention", "expert_ffn_grouped"),
            per_step={"rmsnorm": 17, "flash_attention": 8,
                      "expert_ffn_grouped": 8})
        # the fp8 wire turns the flash and rmsnorm kernels' last-bit
        # differences into whole e4m3 steps where a value sits at a rounding
        # boundary: the first step's gradient norm moved 2.2e-3 (loss 5.8e-5;
        # the CPU tests see the same against JAX), so it is held to 1e-2
        fp8 = replace(cfg, moe=replace(cfg.moe,
                                       comm=CommConfig(wire_dtype="fp8_e4m3")))
        fp8_steps = 5
        path_launches["train_qwen3_s1g_fp8"] = train(
            "qwen3 s1g fp8", fp8, dev, batch=1, seq=2048, steps=fp8_steps,
            lr=1e-4,
            schedule="s1g", grad_rtol=1e-2,
            uses=("moe_dispatch", "expert_ffn_ragged", "moe_combine"),
            per_step={"moe_dispatch": 12, "expert_ffn_ragged": 8,
                      "moe_combine": 8, "rmsnorm": 17, "flash_attention": 8,
                      "expert_ffn_grouped": 0, "expert_ffn": 0})

    if 8 in phases:
        log("phase 8: train gpt2-moe at its full size")
        g2 = get_config("gpt2-moe")
        g2_steps = 5
        path_launches["train_gpt2_moe"] = train(
            "gpt2-moe", g2, dev, batch=8, seq=1024, steps=g2_steps, lr=1e-3,
            uses=("flash_attention", "expert_ffn_grouped"),
            per_step={"flash_attention": 24, "expert_ffn_grouped": 12})
        g2s1 = replace(g2, moe=replace(g2.moe, pipeline_chunks=2))
        path_launches["train_gpt2_moe_s1_pipe2"] = train(
            "gpt2-moe s1 2 chunks", g2s1, dev, batch=8, seq=1024, steps=5,
            lr=1e-3, schedule="s1", uses=("moe_dispatch", "expert_ffn",
                                          "moe_combine"),
            per_step={"moe_dispatch": 18, "moe_combine": 12, "expert_ffn": 24,
                      "flash_attention": 24, "expert_ffn_grouped": 0,
                      "rmsnorm": 0})

    if 7 in phases or 8 in phases:
        # the page-locked host blocks of their first-step checks
        from repro_torch.launch.determinism import release_host_blocks
        release_host_blocks()

    p9_losses = None          # phase 9 (a)'s, phase 12 (e)'s reference
    if 9 in phases:
        # 9. guarded training; the launch predictions per MoE layer and step
        # come from phase 7's fp8 run and phase 8's gpt2-moe run
        log("phase 9: guarded training, gpt2-moe full width, 4 layers")

        def n_moe(c):
            return sum(n for kind, n in c.runs() if "moe" in kind)

        fp8_per_layer = {
            k: path_launches["train_qwen3_s1g_fp8"][k]
            / (fp8_steps * n_moe(fp8))
            for k in ("moe_dispatch", "expert_ffn_ragged", "moe_combine")}
        grouped_per_layer = (
            path_launches["train_gpt2_moe"]["expert_ffn_grouped"]
            / (g2_steps * n_moe(g2)))
        p9, p9_losses = guarded_training(dev, g2, fp8_per_layer,
                                         grouped_per_layer)
        path_launches.update(p9)
        torch.cuda.empty_cache()

    if 11 in phases:
        # 11. the cost model and the autoscheduler on the card ((e) ran after
        # phase 10 (a)-(e), on phase 4's model)
        t0 = time.perf_counter()
        log("phase 11: the cost model and the autoscheduler")
        path_launches.update(autoscheduling(dev, forward_ms, cfg, prompts,
                                            gen))
        log(f"  (a)-(d), (f), (g) in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()

    multi_paths = {}
    if 12 in phases:
        # 12. Parm's schedules across ranks
        t0 = time.perf_counter()
        log("phase 12: Parm's schedules across ranks (gpt2-moe, qwen3's "
            "block, gloo ranks on cuda:0)")
        multi_paths = multirank(dev, p9_losses=p9_losses)
        for path in P12_RZOO_PATHS + P12_XZOO_PATHS:
            path_launches[path] = {k: multi_paths[path].get(k, [0])[0]
                                   for k in KERNELS}
        log(f"  phase 12 in {time.perf_counter() - t0:.1f} s")

    if 13 in phases:
        # 13. the five configs whose block kinds the port runs
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        log("phase 13: yi-9b, mistral-nemo-12b, qwen1.5-0.5b, command-r-35b "
            "and llama4-scout-17b-a16e at full width")
        path_launches.update(zoo(dev))
        log(f"  phase 13 in {time.perf_counter() - t0:.1f} s")

    if 14 in phases:
        # 14. the dry run
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        log(f"phase 14: the dry run (predicted ~25 s, limit "
            f"{P14_LIMIT_S:.0f} s)")
        multi_paths.update(dry_run(dev))
        log(f"  phase 14 in {time.perf_counter() - t0:.1f} s (limit "
            f"{P14_LIMIT_S:.0f} s)")

    if 15 in phases:
        # 15. the recurrent zoo: hymba-1.5b and xlstm-350m at full size
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        log(f"phase 15: the recurrent zoo, hymba-1.5b and xlstm-350m at full "
            f"size, xlstm trained at 8 layers (predicted ~55-90 s, limit "
            f"{P15_LIMIT_S:.0f} s)")
        path_launches.update(recurrent_zoo(dev))
        log(f"  phase 15 in {time.perf_counter() - t0:.1f} s (limit "
            f"{P15_LIMIT_S:.0f} s)")

    if 16 in phases:
        # 16. the cross-attention zoo: llama-3.2-vision-11b and whisper-tiny
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        log(f"phase 16: the cross-attention zoo, llama-3.2-vision-11b and "
            f"whisper-tiny (predicted ~40 s, limit {P16_LIMIT_S:.0f} s)")
        path_launches.update(cross_zoo(dev))
        log(f"  phase 16 in {time.perf_counter() - t0:.1f} s (limit "
            f"{P16_LIMIT_S:.0f} s)")

    if 17 in phases:
        # 17. the examples and bert-moe
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        log(f"phase 17: the examples (quickstart, serve_batched, "
            f"train_100m) and bert-moe trained and served (predicted ~30 s, "
            f"limit {P17_LIMIT_S:.0f} s)")
        path_launches.update(examples(dev))
        log(f"  phase 17 in {time.perf_counter() - t0:.1f} s (limit "
            f"{P17_LIMIT_S:.0f} s)")

    if phases != set(PHASES):
        log(f"chip_smoke: phases {sorted(phases)} passed in "
            f"{time.perf_counter() - t_start:.1f} s (a selection: no "
            f"kernels line)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    # 18. results.  Each kernel's top-level numbers are those of its main
    # path (KERNELS): its launches there, counted from 0 just before the
    # run, and the phase-3 row at the shapes that path gives it.
    # ``by_path`` pairs every path's launches with the phase-3 row at that
    # path's shapes, or null where the path does not launch the kernel.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    by_label = {name: {r["label"]: r for r in rs}
                for name, rs in rows.items()}
    kernels = []
    for name, (source, replaces, main_path, main_label) in KERNELS.items():
        by_path = {}
        for path, launches in path_launches.items():
            label = SHAPE_OF.get((name, path))
            if (launches[name] > 0) != (label is not None):
                raise AssertionError(f"{name}: {launches[name]} launches on "
                                     f"{path}, phase-3 shape {label}")
            by_path[path] = {"launches": launches[name], "shape": label,
                             **{k: by_label[name][label][k] if label
                                else None for k in keys}}
        main_row = by_label[name][main_label]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "main_path": main_path,
            "launches": path_launches[main_path][name],
            **{k: main_row[k] for k in keys}, "by_path": by_path,
            "multirank": {path: per_rank[name]
                          for path, per_rank in multi_paths.items()
                          if name in per_rank},
            "multirank_shape": {
                path: {"shape": label, **{k: by_label[name][label][k]
                                          for k in keys}}
                for (kname, path), label in MULTI_SHAPE_OF.items()
                if kname == name and path in multi_paths}})
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


if __name__ == "__main__":
    sys.exit(main())
