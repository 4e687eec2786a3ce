#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each printing one JSON line:

  1. device: the card (``nvidia-smi`` name and power limit) and the time to
     build every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, in parallel);
  2. kernels: each kernel against its plain PyTorch version on the card at
     the main paths' shapes, with masked and sentinel (dst == A) edges,
     under the tolerances stated below; each kernel, its plain version and
     a one-call PyTorch yardstick (``library_ms``, never used by the port)
     are timed by device time (``torch.profiler``). The edge kernel's
     forward (#3) is checked at the training path's shape (B=40: 5 sources
     x 8 graphs in one trunk pass), at B=8 (A=64, and a serve bucket of
     M = 128), at B=4 (a task-parallel rank's shard, a serve batch split
     over 2 entries), at B=2 (split over 4), at the training bucket (40,
     32, 128) and at a ragged shape, for
     bits over two calls, per output and scratch (out, Pi, Pj, S, deg) at
     B=40, 8, 4 and 2, and timed there (B=40 its summary row) with its
     kernels a call (at most 4) and ``torch.matmul`` of its three
     products beside it (``gemm_library_ms``). Its backward (#4) is checked per
     output and for bits over two calls at B=40 (pos needing no
     gradient), at B=8 with dpos, at B=4 without and at a ragged shape,
     and timed at B=40 (its summary row), B=8 and B=4 with its kernels a
     call (at most 3 without dpos, 4 with) and
     ``torch.matmul`` of its six products beside it; each graph of a
     batched segment-sum must be bitwise equal to that graph alone, in f32
     and bf16;
  3. serve: ``ServeSession`` serves hydragnn-gfm at full width (4 EGNN
     layers at H=866, 5 branches of 3x889 MLPs, fp32, seeded random
     weights) over a bucket grid planned from synthetic five-source
     structures — once under ``segment_sum_impl="fused"`` and once under
     ``"pallas"``. Every request resolves finite; rows are bitwise equal to
     ``predict_one``; the kernel's launch count, zeroed just before the
     pass, equals 4 x batches; both passes agree with each other and with
     the plain forward;
  3b. serve_scaleout: multi-device serving in one process at the same
     width, one card standing in for a mesh (a device list may name it
     several times: each entry is a stream of its own). (a) 8 replicas
     (``make_replica_meshes(8, devices=["cuda"] * 8)``, 8 param copies, 8
     streams, warmed up concurrently) behind the router serve 160
     mixed-head requests under ``"fused"``: every row bitwise equal to a
     single-device ``predict_one``, ``routed`` 160, nothing outstanding,
     #3 launched 4 x batches; structures/s and p50/p99 beside the serve
     phase's fused pass, as information; (b) two replicas, each crashed
     by an injected ``batcher.add`` fault: the trigger fails, the next
     request fails over bitwise right, with both dead submit raises
     ``ServeClosedError``, ``restart_workers()`` returns 2 and serving is
     bitwise right again; (c) a burst of 40 with ``max_wait_ms=100`` closed
     at once: every future resolves without error, a later submit raises;
     (d) ``ServeSession(mesh=)`` with a batch's rows split over 2 and 4
     entries, under ``"fused"`` and ``"pallas"``: rows bitwise equal to
     the session's own ``predict_one`` and within ``SERVE_TOL`` of one
     device (whether bitwise is recorded), ``max_batch=6`` on 4 entries
     raises, #3 (fused) or #2 (pallas) launched 4 x entries x batches;
     (e) five cycles of an 8-replica session opened, warmed up, serving
     40 requests and closed: the bytes allocated on the card after each
     (the cuBLAS workspaces of every (handle, stream) pair that ran a
     GEMM) stay at the first cycle's, the serving streams coming from a
     pool keyed by the thread's cuBLAS handle;
  4. train: ``Session`` trains hydragnn-gfm at full width under
     ``"fused"`` for 10 steps (5 synthetic sources, 8 graphs each per step,
     A=64, E=2048, AdamW, a checkpoint). Every loss is finite; the forward
     and backward edge kernels, counted from zero over the run, launch 4
     times per step each (one trunk pass over all 40 graphs, 4 layers);
     one step's gradients match the plain path's (``"jnp"``, autograd,
     no kernel: its species embedding's backward is the one-hot product)
     on the same batch, and #1 on that step's own embedding cotangent
     (B·A ids into the species table, F=866) is bitwise equal to a plain
     token-order sum and within the rounding bound of the one-hot
     product, in f32 and bf16 (``_check_embed``; so too in train_pipeline,
     gnn_bf16, finetune and lm_train); two 3-step runs from one seed
     end with bitwise equal parameters under each of ``"fused"``,
     ``"scatter"``, ``"jnp"`` and ``"pallas"`` (``TRAIN_REPLAY_IMPLS``: on
     the card ``"scatter"`` and ``"pallas"`` sum with #2 and every node
     gather's backward sums with #2 in edge order);
     ``ServeSession.from_checkpoint`` serves requests from the written
     checkpoint;
  4b. train_pipeline: the multi-source pre-training path at the same
     width, over the same 5 sources. (a) MTL-All, ``mixing=1.0`` (loss
     weights) and ``bucketing=3``, 10 steps: losses finite, 4 + 4 edge
     kernel launches a step, the bucket shapes met and the pad fraction
     before and after the trim, one bucketed batch's gradients within
     ``GRAD_TOL`` of the plain path and its loss within ``GRAD_TOL`` of
     the untrimmed batch's, two 3-step runs bitwise equal, one step's
     device time and host-clock ms bucketed beside unbucketed, and #3 and
     #4 against their plain versions per output at every bucket shape up
     to (32, 128) at B=40; (b) Baseline-All (``gfm-baseline``, 40 graphs
     a step from the mixture, bucketed): the same launches, replay
     bitwise; (c) ``write_store`` of the sources under
     ``build/chip_smoke/store``: 12 ``PrefetchingBatcher`` batches equal to
     ``GroupBatcher``'s on the card, a 3-step session fed by it bitwise
     equal to the in-memory session; (d) a resilient run hit by every
     fault kind (``SOAK_FAULTS``), then ``resume()`` in a fresh session:
     params, moments and step bitwise equal to a clean 12-step run; the
     report's events and each checkpoint write's ms;
  4b2. analysis: ``repro_torch.analysis``'s sanitizers on the port's
     seams at the same width. (a) the recompile budget: ``Session`` trains
     (fp32, ``"fused"``, ``bucketing=3``: the data meets the (32, 128)
     bucket, 5 x 8 graphs a step) one warm step; then a
     ``RecompileSanitizer(budget=0)`` tracks the session
     (``track_session``), #3's split plans (``gemm_plan.w1_splits``,
     ``fwd_splits``) and the kernel libraries (``kernels._build``); 19
     more steps add 0; ``quarantine_tasks([4])`` and one step add exactly
     the session's 1 and ``check()`` raises (the seeded violation); #3, #4
     and #1 launch 4, 4 and 1 a step; each probe's count printed. (b) a
     router of 2 replicas (``ReplicaServeSession``) warmed over its
     buckets serves 80 mixed-head requests under ``"fused"`` (#3, 4 x
     batches): a ``RecompileSanitizer(budget=0)`` over ``jit_functions()``
     counts 0 and no replica runs a shape outside its warmed set; a
     ``ThreadSanitizer`` records 0 violations of three contracts: each
     replica's ``RequestQueue`` drained by one worker (``get`` / ``drain``
     as one exclusion group, through the closing drain), every launch
     count moved under ``_build``'s counter lock, the serving streams'
     pool's table touched under its lock. (c) the memory model is
     ``train_mtp``'s check below;
  4c. train_mtp: multi-task parallelism (the paper's method) at the same
     width, the trunk cut to 2 of its 4 EGNN layers (``MTP_LAYERS``: the
     contract's time): ranks spawned by ``launch.mesh.run_ranks`` on the
     one card over gloo (NCCL refuses two ranks on one card), each a
     ``Session`` of 3
     steps with the paper's source sizes as task weights. (a) ``hier``:
     8 ranks, ``placement=8`` — groups (2, 1, 3, 1, 1), per-rank B of 4 or
     8; (b) ``par``: a (1, 5) mesh, one head a rank; (c) ``base``: a (2, 1)
     mesh, heads whole. Each: per-task and total losses within rtol 5e-5,
     atol 1e-6 of the one-process session on the same batches; trunk
     params bitwise equal across ranks after every step; 2 + 2 edge-kernel
     launches a step a rank; each rank's params and moments equal to the
     §4.3 model, its group's ``hbm_bytes`` from
     ``launch.memory.hier_group_memory`` (a flat plan's groups read off
     its mesh by ``plan_placement``), beside ``memory_allocated``. (a) also: two runs bitwise equal, the checkpoint
     rank 0 writes read back by every rank (its own rows) and bitwise into
     a one-process session, and per rank the step's device time and
     host-clock ms and the trunk's and the group's all-reduce ms — ranks
     that time-share one card, not a scaling result;
  4d. gnn_bf16: hydragnn-gfm at full width in bf16 compute (fp32 params,
     ``compute_dtype=torch.bfloat16``) through the bf16 variants of #3 and
     #4. Kernels, in phase 2's turn: #3 in bf16 (``check_egnn_edge``
     with the compute dtype) against ``egnn_edge_agg_ref`` at bf16 within
     ``EDGE_BF16_TOL`` at phase 2's shapes (B=40, 8, 4 and 2 at A=64,
     E=2048, the buckets (8, 16, 512) and (40, 32, 128), a ragged shape),
     bits over two calls, launched on its own counter
     (``egnn_edge_agg.bf16``), the kernel's and the plain version's error
     against a float64 forward, and at B=40/8/4/2 its f32 scratch and
     device time beside the plain version, the f32 #3 and
     ``torch.matmul`` bf16 of its three products; #4 on bf16 g, h and
     weights at B=40 (no dpos) and B=8 (dpos), through the autograd
     Function on a bf16 h leaf within ``BWD_TOL`` of the plain version,
     and its launch bitwise equal to #4's f32 launch on the upcast values,
     timed beside it. Then (b) 80 requests served
     under ``"fused"`` and ``"pallas"``: rows bitwise equal to
     ``predict_one``, within ``EDGE_BF16_TOL`` of the plain (``"jnp"``)
     bf16 forward, the bf16 #3 launched 4 x batches (no f32 launch), the
     distance from phase 3's f32 rows recorded; (c) 10 steps of 5 x 8
     graphs: losses finite, 4 + 4 bf16 edge launches a step, one step's
     gradients within ``EDGE_BF16_TOL`` of the plain bf16 path (x max(1,
     max|ref|)) and each leaf within ``BF16_GRAD_NORM_TOL`` of its own
     size, two 3-step runs bitwise equal, params fp32,
     ``ServeSession.from_checkpoint`` serving in bf16;
  4e. finetune: the paper's downstream fine-tuning at hydragnn-gfm's full
     width, through ``examples/finetune_downstream_torch.py``'s functions:
     a ``Session`` pre-trains 5 steps on 3 sources x 8 graphs, then a
     fresh branch and the trunk (a ``SingleTaskModel`` through
     ``ShardingPlan().compile(make_step(...))``) tune 5 steps on 12
     transition1x graphs from the pre-trained trunk and from a scratch
     one. Every loss finite; #3, #4 and #1 (the species embedding's
     backward), counted from zero, launch 4, 4 and 1 a step; one step's
     gradients within ``GRAD_TOL`` of the plain path; ``accum=2`` on the
     flat batch within ``GRAD_TOL`` of the mean of its halves' gradients
     (its distance from ``accum=1``, whose force term normalises over all
     12 graphs' atoms, recorded); two runs from one seed bitwise equal;
     the trunk's params move; the held-out MAEs (64 graphs) through the
     kernels within ``SERVE_TOL`` of the plain forward's, both MAEs and
     their ratio recorded as information;
  5. lm kernels: flash attention (#5) and flash decode (#6) against their
     plain versions on the card, f32 and bf16, causal with and without a
     window and bidirectional, GQA (G = 1, 2, 3, 4, 7, 8, 16), head dims
     16 to 192, ragged
     lengths, rotated (rolling) positions with pads,
     and for #6 splits with no valid key and splits past the cache end;
     timed beside ``scaled_dot_product_attention`` (``library_ms``, never
     used by the port);
  6. lm_serve: ``greedy_generate(impl="pallas")`` serves h2o-danube-1.8b
     at full width (24 swa layers, d=2560, 32/8 heads, hd 80, window 4096,
     bf16 compute over fp32 weights drawn on the card from a seed) in two
     runs: (a) B=8, a 1024-token prompt from ``lm_data``, 32 new tokens;
     (b) B=1, a 4200-token prompt (past the window: the prefill's window
     mask and the rolling cache), 16 new tokens. Launches counted from
     zero: #5 = 24 per prefill, #6 = 24 per decode step. Checks:
     teacher-forced logits (prefill + 8 decode steps) of the kernel path
     against the plain path, in bf16 and in f32 compute; two runs of (a)
     bitwise equal; one ``task=`` decode step of a 3-head tree. Records
     the device time of one prefill at (a) and the bf16 GEMM reduction
     setting (``repro_torch`` pins it off);
  6b. lm_train: qwen1.5-0.5b at full width (24 layers, d=1024, 16 heads,
     d_ff 2816, padded vocab 152064, tied table, bf16 compute over fp32
     params drawn on the card from a seed, ``impl="chunked"``, per-block
     remat): (a) ``lm``, B=8 x 1024 ``lm_data`` tokens, 5 AdamW steps;
     (b) ``lm-mtl``, 4 tasks x 2 x 1024, 3 steps. Losses finite; #1
     launched once a step (the embedding's backward); #1 on one step's own
     embedding cotangent, in bf16 (the path) and f32, against its plain
     versions on the card (``_check_embed``); two 3-step runs of (a)
     bitwise equal; peak memory, one step's device time, its top kernels
     and host-clock ms. Then the ``segment_sum_2d`` kernel line: #1 at
     the embedding's shape, bitwise equal at the carried plan, timed beside
     it, the f32 one-hot plain version, the bf16 one-hot product the
     backward was before, ``index_add_`` and the byte bound;
  6c. lm_moe: the MoE family at full width, weights drawn on the card
     from a seed, bf16 compute: granite-moe-3b-a800m (d=1536, 24/8 heads
     of 64, 40 experts top-8 of width 512, fp32 weights) cut to 6 of its
     32 layers (``GRANITE_LAYERS``) and
     deepseek-v2-236b (d=5120, 128 heads, MLA latent 512 / q 1536, rope
     64 + nope 128, 160 experts top-6 of width 1536 plus 2 shared, bf16
     weights) cut to 2 layers served and 1 trained. Each
     is served by
     ``greedy_generate(impl="pallas")`` (B=8, a 1024-token prompt, 32 new)
     twice, bitwise equal, launches counted from zero (#5 once a layer a
     prefill; #6 once a layer a decode step on granite's GQA, never on
     deepseek's absorbed MLA decode); its teacher-forced logits (prefill
     + 8 decode steps) on the kernel path within ``LM_TOL_BF16`` of the
     plain path's; its decode steps (#6, or MLA's absorbed form over the
     latent cache) within ``LM_TOL_BF16`` of the full forward of the same
     tokens (#5; MLA up-projected), capacity made ample (E/k) so that no
     grouping drops a token; one prefill and one decode step profiled,
     device time beside the host clock. Then ``lm`` trains 3 steps of B=2
     x 1024 (``impl="chunked"``, per-block remat, the donated AdamW
     update: the state is held once), twice from one seed, bitwise; #1
     once a step, held on one step's embedding cotangent
     (``_check_embed``) and timed at that shape beside ``index_add_``;
     peak memory; one step profiled. Phase 5 holds #5 at the MLA
     prefill (B=8, S=1024, H=K=128, D=192, bf16 and f32) and granite's
     (24/8 heads, D=64) and #6 at granite's decode (G=3, cache 1056);
  6d. lm_recurrent: the recurrent family at full width, fp32 weights
     drawn on the card from a seed, bf16 compute: zamba2-1.2b (38
     layers, d=2048: Mamba2 blocks of 64 heads and state 64, and one
     shared attention block, 32 heads of 64, window 4096, applied at 6
     layers through per-layer LoRA adapters; served at 12 layers, two
     applications: ``REC_ZAMBA_LAYERS``) and
     xlstm-125m (d=768, mLSTM and sLSTM in turn; 2 of its 12 layers,
     ``REC_XLSTM_LAYERS``: its host-bound scans run no kernel of the
     port). Each is served by
     ``greedy_generate(impl="pallas")`` at (a) B=8, a 1024-token prompt,
     32 new, twice, bitwise equal, and zamba2 also at (b) B=1, a
     4200-token prompt past its window, 16 new (the rolling cache, SSD's
     chunk padding); launches counted from zero (#5 once a shared layer a
     prefill, #6 once a shared layer a decode step, none for xlstm); the
     kernel path's teacher-forced logits within ``LM_TOL_BF16`` of the
     plain path's at (a) and (b); decode against the full forward, in
     f32 within ``LM_TOL_F32`` and in bf16 no further from the f32
     forward than twice the bf16 forward (or ``LM_TOL_BF16``); one
     prefill and one decode step profiled. Then ``lm``
     trains 3 steps of 8 x 1024 tokens (zamba2 cut to 12 of 38 layers,
     ``REC_TRAIN_LAYERS``; xlstm 8 x 256, its sLSTM scan took 20.6 s a
     step at 1024) through ``Session`` (``impl="chunked"``,
     per-block remat), twice, bitwise; #1 once a step, held on one step's
     embedding cotangent and timed at its shape beside ``index_add_``;
     peak memory; one step profiled. Phase 5 holds #5 and #6 at the
     shared block's shapes (G=1, D=64, runs (a) and (b)). Each phase
     starts with the garbage collected, the cuBLAS workspaces of earlier
     phases freed and the peak counter reset; the ``memory`` line gives
     the bytes still allocated at each phase's start, before and after;
  6e. lm_frontends: the modality frontends and the encoder-decoder at
     full width, cut in depth (``FRONT_SERVE_LAYERS``:
     internvl2 8 of its 24 layers, seamless 4 + 4 of its 12 + 12), fp32
     weights drawn on the card from a seed, bf16 compute: internvl2-1b
     (24 layers, d=896, 14 / 2 heads of 64,
     qkv bias, a vision projector putting 256 seeded frames of width 1024
     before the text) and seamless-m4t-medium (12 encoder and 12 decoder
     layers, d=1024, 16 heads of 64, layernorm, an audio projector, 4096
     seeded source frames). seamless's ``encode`` of 8 x 4096 frames
     through #5 (bidirectional, once a layer) within ``LM_TOL_BF16`` of
     the plain path's memory. Each served twice at B=8, bitwise equal:
     internvl2 by ``make_prefill_step(media=)`` over 256 + 768 positions
     and 31 decode steps from position 1024 (#5 once a layer a prefill,
     #6 once a layer a step), seamless by ``greedy_generate(memory=)`` on
     a 1024-token prompt (#5 twice a layer a prefill, self and cross; a
     step #6 once a layer and #5 once, the cross-attention of one query);
     teacher-forced logits (prefill + 8 steps) of the kernel path within
     ``LM_TOL_BF16`` of the plain path's, decode within it of the full
     forward (argmax agreement beside); one prefill, decode step and
     encode profiled, and the f32 unembedding's device time beside the
     prefill's. Then ``lm`` trains 3 steps (internvl2 8 x (256 media +
     768 text), seamless 2 x 1024 with 4096 frames, the batch cut from 8:
     its encoder keeps every layer's attention probabilities under
     autograd; and 6 of its 12 + 12 layers, ``FRONT_TRAIN_LAYERS``),
     twice, bitwise; #1 once a step, held on one step's
     cotangent and timed at its shape; peak memory; one step profiled.
     Phase 5 holds #5 at seamless's encoder, cross-attention (1024 and 1
     query over 4096 keys, positions 0), causal self-attention and
     internvl2's prefill (G = 7), and at cross and causal shapes with
     distinct positions and pads; #6 at G = 7 and at seamless's decode;
  6f. lm_dense12b: the 12 B dense models, fp32 weights drawn on the card
     from a seed, bf16 compute, one model on the card at a time:
     gemma3-12b (48 layers, d=3840, 16 / 8 heads of 256, five sliding-
     window layers (1024) to one full-attention layer, vocab 262,144;
     11.77 B parameters) and stablelm-12b (40 layers, d=5120, 32 / 8
     heads of 160, vocab 100,352; 11.63 B). Each served at full width, cut
     in depth to 6 / 6 layers (``DENSE_SERVE_LAYERS``: the contract's
     time), by ``greedy_generate(impl="pallas")`` at (a) B=8, 1024 + 32,
     twice, bitwise, and gemma3 at (b) B=1, 4200 + 16 past its window (#5
     once a layer a prefill, #6 once a layer a step); the kernel path's
     teacher-forced logits within ``LM_TOL_BF16`` of the plain path's at
     both shapes, and against the full forward of the same tokens:
     gated for stablelm and for gemma3 under its window (2 x 248 + 8),
     reported for gemma3 at (a) and (b), where ``repro``'s
     ``extend_caches`` keeps every k/v cache at the prompt's length (the
     full-attention layers' too) and a decode step overwrites their oldest
     slot; a prefill and a decode step profiled, the f32 unembedding
     beside the prefill. Then ``lm`` trains through ``Session`` with its
     donated AdamW (``donate=True``), cut in depth only (gemma3 6 of 48
     layers, one 5:1 unit; stablelm 8 of 40), 3 steps of 2 x 1024, twice,
     bitwise; #1 once a step, held on one step's cotangent and timed at
     its shape; one step profiled. No run may peak above 75 GB. Phase 5
     holds #5 at both models' prefill shapes (gemma3 causal and windowed
     at (a) and (b)) and #6 at their decode shapes, and each new head dim
     in f32;
  6g. train_dist: training across ranks, one ``run_ranks`` job of 2 gloo
     ranks on the one card (a (2, 1) mesh), every case at full width
     against a one-process session on the card run first and freed
     before the spawn: (a) fine-tuning data-parallel (hydragnn-gfm's
     trunk, 4 EGNN layers at H=866, and a fresh 3x889 branch: the
     ``SingleTaskModel`` of ``examples/finetune_downstream_torch.py``, 8
     transition1x graphs a step); (b) ``lm`` on qwen1.5-0.5b at ``DIST_LM``
     = 2 x 512 tokens a rank, at accum 1 and 2; (c) ``lm-mtl`` on qwen's
     two task heads on the ``"base"`` plan, each task's rows split over
     both ranks; (d) granite-moe-3b-a800m ``lm`` cut in depth to
     ``DIST_MOE_LAYERS`` = 2 of 32 (the balance term across ranks); (d')
     ``dp_spec``: xlstm-125m (2 of 12 layers, ``REC_XLSTM_LAYERS``) on a
     ``spec_fn`` plan over a ``DIST_DP_SPEC_MESH`` = (1, 2) mesh (each
     rank its blocks, the mixers' projections and the vocab split over
     ``model``), whose recurrent family keeps the data-parallel step
     (``engine.step.sharded_grad_fn``: the cut leaves gathered whole over
     gloo, the whole gradient all-reduced), 2 steps against one process,
     the bytes a rank holds equal to its blocks'; the
     LMs in f32 compute (``_dist_spec`` says why); 2 steps each; (e) the
     GFM-MTL soak on the ``"base"`` plan under ``SOAK_FAULTS`` (the five
     fault classes), ``resume()``, and a clean 2-rank run. Signals: per-task
     and total losses within ``MTP_RTOL`` / ``MTP_ATOL`` of one process
     (the soak: its clean run's first 2 steps) and the sum of AdamW's
     second moments within ``DIST_V_TOL`` (a gradient off by a constant
     factor, which AdamW's update hides from the losses, moves it); the
     params equal on every rank that holds them after every step (a
     fingerprint of each leaf's or block's bits); launches a rank from zero, as the design
     implies (#3 and #4 4 a GNN step, #1 one a microbatch); the soak's
     resumed run bitwise equal to the clean one, every rank at the same
     step with the same events and checkpoint listing; gloo's all-reduce
     ms a step a rank, each case's peak, and the job's startup, ranks and
     teardown seconds (time-shared, not a scaling result). Then a job of
     its own, 4 gloo ranks on a ``DIST_SPEC_MESH`` = (2, 2) ``(data,
     model)`` mesh, computes qwen1.5-0.5b (full width: 24 layers, d 1024,
     16 heads, vocab 151,936; f32, ``fsdp=True``) tensor-parallel on a
     ``spec_fn`` plan: each rank its blocks, 8 of the 16 heads, half the
     vocab, the FSDP leaves all-gathered a layer at a time and their
     gradients reduce-scattered, on CUDA tensors through gloo: (f)
     ``lm_spec`` trains 2 steps of ``DIST_LM`` rows against one process
     (losses and v as (a)-(d), params bitwise across ranks, the bytes a
     rank holds equal to its blocks', #1 once a step over its vocab
     block); (g) ``tp_serve`` (``fsdp=True`` too: every prefill and
     decode step all-gathers each layer's FSDP leaves over ``data``)
     prefills the ``DIST_LM`` rows (one a data rank) and takes
     ``DIST_TP_NEW`` = 8 greedy tokens by
     ``greedy_generate(impl="pallas")``: tokens equal to one process's,
     logits within ``LM_TOL_F32``, #5 24 times and #6 24 a step on every
     rank; (h) ``moe_tp``: granite-moe-3b-a800m at full width (d 1536,
     24 / 8 heads, 40 experts top-8, ``d_ff_expert`` 512) cut to
     ``DIST_MOE_LAYERS``, f32, ``fsdp=True``, trained as (f): 20 of the 40
     experts a rank, its routing replicated and one SUM over ``model`` a
     layer, held as (f), #1 once a step; (i) ``mla_serve``:
     deepseek-v2-236b at full width cut to ``DEEPSEEK_LAYERS[1]`` = 1
     layer, bf16 as configured, ``fsdp=False``, served as (g): 64 of 128
     MLA heads and 80 of 160 experts a rank (~5 GB of its ~10 GB), #5 once
     a layer at q/k head dim 192 and no #6 (the absorbed decode), tokens
     equal to one process's but where its top two logits lie within
     ``LM_TOL_BF16`` (the near-tie rule, printed), logits within
     ``LM_TOL_BF16`` x max|logit|; (j) ``mtl_tp``: qwen1.5-0.5b's lm-mtl
     (4 per-source heads, ``"par"``: 2 a ``model`` rank) at full width cut
     to ``MTL_TP_LAYERS`` = 2, f32, ``fsdp=True``, on a ``shared_spec_fn``
     plan: the trunk tensor-parallel as (f), every task's row of the
     rank's data slice through it, then Megatron's f and the rank's 2
     heads on its own tasks' rows; trained 2 steps of one 512-token row a
     task a data rank, held as (f) with the per-task losses too, the
     bytes a rank holds equal to its trunk blocks and its 2 heads (params
     and both moments), no ``ShardingPlan.gather``, #1 once a step; (k)
     ``xattn_serve``: seamless-m4t-medium at full width (d 1024, 16 / 16
     heads, vocab 256,206) cut to ``XATTN_LAYERS`` = 2 + 2, f32, served
     as (g) from ``XATTN_FRAMES`` = 1024 seeded source frames a row,
     encoded on the rank's blocks (``make_encode_step``): its 8 of 16
     heads in every encoder block, decoder self-attention and
     cross-attention, #5 once an encoder layer, twice a decoder layer in
     the prefill and once a decoder layer a decode step (the one-query
     cross-attention), #6 once a decoder layer a decode step; the memory
     and the logits within ``LM_TOL_F32`` of one process's, tokens equal;
     each case's peak and host seconds a rank;
  6h. dryrun: one rank's program of a sharded plan, counted and run
     (``repro_torch.launch.dryrun``). The process opens a fake world (the
     ``"fake"`` process-group backend: collectives move nothing) as rank 0
     of (a) the paper's mesh, 100 x 5 = 500 ranks, hydragnn-gfm at full
     width, ``"par"``, ``"fused"``, one graph a task a rank, and (b) the
     16 x 16 production pod, granite-moe-3b-a800m (``fsdp=True``) at
     ``train_4k`` cut to ``DRY_LM_LAYERS`` = 3 of 32 layers, 16 x 4096
     tokens a rank at accum 2; each rank's step is counted on fake tensors
     (FLOPs, op bytes, collectives, ``MemTracker``'s peak; (b)'s fitted
     from 1 and 2 layers, as the sweep fits every deep model), then run on
     the card at full depth with seeded tensors and the kernels. Signals: the rank's state
     bytes (params, m, v) equal on the card, in the count and by
     ``param_bytes_per_device``'s sharded count; the collectives' kinds and
     counts equal; the measured peak within ``DRY_PEAK_BAND`` of the
     static one; a finite loss; launches #3 4, #4 4, #1 1 for (a) and #1
     one a microbatch for (b). (b) keeps the data-parallel step on the
     pod (naive_tp's fractional heads: 24 over ``model`` 16): its rank
     gathers every cut leaf whole;
  7. the ``kernels`` summary line (#1 ``segment_sum_2d`` apart from #2
     ``segment_sum`` since #1 runs every embedding's backward), the
     ``nvidia-smi`` line, and the final ``{"ok": true, "device": ...}``
     line.

``--phase analysis``, ``train_mtp``, ``train_dist``, ``train`` or
``dryrun`` builds the kernels and runs that phase alone (no contract
line). ``--profile`` adds device time
by kernel (``torch.profiler``) for one
served GNN batch, one training step, one LM prefill and one decode step,
and the attention sweep: the device time of #5 over masks (beside SDPA on
the same inputs), and of #6 at LM decode runs (a) and (b), by kernel
name, over 1 / 2 / 3 / 4 / 9 / 17 / 33 splits and the default plan at
(a), beside SDPA and the bound. ``--sweep`` prints only the sweeps: #4 by
kernel at B=40 (no dpos) and B=8 (dpos); #3 by kernel at both, with a
hash of its outputs and their relative error against a float64 forward
(and, where the checkout's launcher takes them, its time over split
counts and column tiles); one training step's device time and host-clock
ms; #1 and #2 beside ``index_add_`` (and #1 at the LM embedding's
shape by node block, on ``lm_train``'s Zipf ids and on uniform ids),
that attention sweep, and the LM prefill's device time with its
teacher-forced bf16 error under the bf16 GEMM reduction setting in
force. ``--src DIR`` imports the port from another unpacked checkout;
with ``--sweep`` it times that checkout and this one in turns (parent,
change, change, parent), each turn in its own process, and ends with a
summary line of the kernels' times by turn:

    python3 chip_smoke.py --sweep --src build/parent/src

Any failure exits nonzero. Without a GPU, or without the repository around
it, the script exits nonzero before printing any result. It imports no JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.modules["jax"] = None          # the port must never reach JAX
_IMPORTED = time.monotonic()       # in a rank: when its process imported
                                   # this file (a job's startup, split)

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32, non-tensor
TF32_FLOPS = 495e12                # H100 SXM TF32 tensor cores, dense
SS_TOL = 1e-5                      # segment-sum: f32 sums of <= ~60 terms
EDGE_TOL = 1e-4                    # egnn_edge: 866/1733-term contractions
                                   # grouped differently (node projections)
BWD_TOL = 1e-4                     # egnn_edge backward, per output and
                                   # relative to its largest entry: the
                                   # same regrouping, weight gradients
                                   # summed over up to B·A nodes
SERVE_TOL = 1e-4                   # full forward, 4 layers + heads
GRAD_TOL = 1e-4                    # train step grads vs the plain path,
                                   # per leaf, relative to its largest entry
ATTN_TOL_F32 = 2e-5                # flash kernels vs plain, x max(1, |ref|):
                                   # online softmax summed in another order
ATTN_RTOL_BF16 = 2.0 ** -7         # bf16, per element: |got - ref| <=
                                   # 2^-7 |ref| + the f32 tolerance; both
                                   # sides compute in f32 from the same
                                   # bf16 inputs and round once to bf16,
                                   # which moves a value by at most 1 ulp,
                                   # and 1 ulp is at most 2^-7 of it
LM_TOL_F32 = (2e-4, 2e-3)          # teacher-forced logits, f32 compute,
                                   # atol/rtol (repro's own test_serve)
LM_TOL_BF16 = 5e-2                 # ... bf16 compute, x max|ref logit|:
                                   # bf16 roundings of attention outputs
                                   # flip where the sums' order differs and
                                   # spread through the residual stream;
                                   # the two plain paths at full width on
                                   # the CPU differ by 0.026/0.046/0.064 at
                                   # 2/4/8 layers (max |logit| ~4.9), ~0.11
                                   # at 24 by sqrt(L); tolerance ~0.25
BF16_FLOPS = 989e12                # H100 SXM bf16 tensor cores, dense
EDGE_BF16_TOL = 4e-2               # bf16 compute, x max(1, |ref|): #3,
                                   # served rows, grads per leaf (and
                                   # the loss, relative); repro's own bf16
                                   # tolerance (tests/test_egnn_paper_
                                   # shape.py): kernel and plain version
                                   # round to bf16 at other points (the
                                   # kernel's z is f32, the plain one's
                                   # bf16 per edge)
BF16_GRAD_NORM_TOL = 0.1           # bf16 compute, each gradient leaf's
                                   # |fused - plain| / |plain| (2-norms), as
                                   # well: a leaf of small gradients is held
                                   # to its own size. Read up to 2.1e-2 on
                                   # an H100 (heads/force/fc2/w); on the
                                   # CPU the port's leaves up to 4.5e-2
                                   # from repro's at bf16, repro's own bf16
                                   # from its f32 up to 3.9e-2 (tests/
                                   # test_torch_bf16.py); a zero or wrong
                                   # leaf reads ~1
N_REQUESTS = 80                    # mixed-head requests per serving pass
TRAIN_STEPS = 10
TRAIN_REPLAY_IMPLS = ("fused", "scatter", "jnp", "pallas")  # phase train's
                                   # seed replay, two 3-step runs each
DEVICE = "cuda"                    # the serve_scaleout, train and lm_serve
                                   # phases' device


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def device_profile(torch, fn, iters=20, warm=3, cpu=True) -> dict:
    """Device time of one call of ``fn`` (``ms``): the kernels it launches,
    summed from a ``torch.profiler`` trace of ``iters`` calls, also by
    kernel name (``by_kernel``, ms a call), and the kernels a call
    launches (``kernels_per_call``). Unlike CUDA events around the calls,
    it leaves out the device's idle time while the host prepares the next
    launch, which dominates calls of tens of us. ``cpu=False`` traces the
    device alone: no event a host-side op, for calls of ~10^5 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    # a trace with no device event at all is the profiler's drop, not the
    # call's (its kernels ran in the warm-up): trace again, three at most
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    for _ in range(3):
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            # lint: allow(TRC003): the trace must close after its kernels
            torch.cuda.synchronize()
        by_kernel, launches = {}, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.device_time_total:
                name = (ev.key.split("(")[0].split("<")[0].split()
                        or [ev.key])[-1]
                by_kernel[name] = (by_kernel.get(name, 0.0)
                                   + ev.device_time_total / iters / 1e3)
                launches += ev.count
        if launches:
            break
    return {"ms": sum(by_kernel.values()), "by_kernel": by_kernel,
            "kernels_per_call": launches / iters}


def device_ms(torch, fn, iters=20, warm=3) -> float:
    """``device_profile``'s device time of one call of ``fn``."""
    return device_profile(torch, fn, iters, warm)["ms"]


def scaled_err(torch, got, ref) -> tuple[float, float]:
    err = float((got.float() - ref.float()).abs().max())
    return err, max(1.0, float(ref.float().abs().max()))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def edge_case(torch, B, E, A, g, dev):
    src = torch.randint(0, A, (B, E), generator=g, device=dev)
    dst = torch.randint(0, A + 1, (B, E), generator=g, device=dev)  # A: pad
    em = (torch.rand((B, E), generator=g, device=dev) < 0.85) & (dst < A)
    return src, dst, em


def _ss_library(torch, msg, routed, em, A):
    """``index_add_`` computing the same sums (masked edges into a spare
    row): the one-call yardstick, never used by the port."""
    B = msg.shape[0] if msg.dim() == 3 else 1
    F = msg.shape[-1]
    b_off = A * torch.arange(B, device=msg.device)
    flat_idx = torch.where(
        em, routed + (b_off[:, None] if routed.dim() == 2 else 0),
        torch.full_like(routed, B * A)).reshape(-1)
    flat_msg = msg.reshape(-1, F)

    def library():
        # lint: allow(ATM001): library_ms yardstick, on no port path
        torch.zeros((B * A + 1, F), device=msg.device).index_add_(
            0, flat_idx, flat_msg)
    return library


def _ss_bound(B, E, A, F, n_valid):
    """Bytes (valid messages, dst, output, f32) over HBM, or f32 adds over
    the FFMA peak, whichever is larger."""
    nbytes = 4 * (n_valid * F + B * E + B * A * F)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_valid * F / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


def check_segment_sum(torch, dev, g):
    """#1/#2 against the plain version at the serve path's shape (B=8), a
    ragged E and one graph (2-D); each graph of the B=8 call bitwise equal
    to a call on that graph alone, in f32 and bf16; timed by device time
    (``torch.profiler``) beside ``index_add_``."""
    from repro_torch.kernels.segment_sum import ops, segment_sum_ref
    cases = [("main", 8, 2048, 64, 866), ("ragged_e", 8, 1000, 64, 866),
             ("b1_2d", 1, 2048, 64, 866)]
    worst, out = 0.0, {}
    for name, B, E, A, F in cases:
        msg = torch.randn((B, E, F), generator=g, device=dev)
        _, dst, em = edge_case(torch, B, E, A, g, dev)
        if name == "b1_2d":
            msg, dst, em = msg[0], dst[0], em[0]
        got = ops.segment_sum(msg, dst, A, edge_mask=em)
        routed = torch.where(em, dst, torch.full_like(dst, A))
        ref = segment_sum_ref(msg, routed, A)
        # lint: allow(TRC003): each case's check reads back anyway
        torch.cuda.synchronize()
        err, scale = scaled_err(torch, got, ref)
        if not err <= SS_TOL * scale:
            fail(f"segment_sum {name}: max_abs_err {err} > {SS_TOL}*{scale}")
        worst = max(worst, err)
        if name == "main":
            # rows independent of the batch: graph b alone, same bits
            for dt in (torch.float32, torch.bfloat16):
                m = msg.to(dt)
                full = ops.segment_sum(m, dst, A, edge_mask=em)
                for b in range(B):
                    one = ops.segment_sum(m[b:b + 1], dst[b:b + 1], A,
                                          edge_mask=em[b:b + 1])
                    if not torch.equal(full[b], one[0]):
                        fail(f"segment_sum {dt}: graph {b} of the B={B} "
                             f"call differs bitwise from the graph alone")
            out["rows_bitwise_vs_b1"] = ["float32", "bfloat16"]
        if name == "ragged_e":
            continue
        d32 = routed.to(torch.int32).contiguous()
        n_valid = int(em.sum())
        ms = device_ms(torch, lambda: ops.segment_sum(msg, d32, A), iters=50)
        wall = time_ms(torch, lambda: ops.segment_sum(msg, d32, A), iters=50)
        plain = device_ms(torch, lambda: segment_sum_ref(msg, routed, A))
        lib = device_ms(torch, _ss_library(torch, msg, routed, em, A),
                        iters=50)
        timed = {"ms": ms, "wall_ms": wall, "plain_ms": plain,
                 "library_ms": lib, "library": "index_add_ (with its zero "
                 "fill)", "shape": [B, E, A, F], "valid_edges": n_valid,
                 **_ss_bound(B, E, A, F, n_valid)}
        if name == "main":
            out.update(timed)
        else:
            out[name] = timed          # segment_sum_2d's shape: one graph
    out["max_abs_err"] = worst
    return out


def _edge_fwd_bound(B, A, E, H, n_valid, bf16=False):
    """#3's least time on the card for these inputs: its three node-level
    products (2·B·A·H² each) on the tensor cores, in f32 compute as three
    TF32 products each (the 3xTF32 split), in bf16 (``bf16``) once each at
    the bf16 rate, plus ~8 operations per valid edge and column at the fp32
    peak (``bound_ms``), the same work all in fp32 FFMA
    (``bound_ffma_ms``), and the bytes (h, pos, src, dst and the weights
    read once; out and the scratch the backward reads, Pi, Pj, S and deg,
    written once; h, the weights and out in the compute dtype, the rest
    4 bytes a value) at HBM speed; each bound the larger of its operations
    time and the bytes time."""
    gemm_ops = 3 * 2 * B * A * H * H
    edge_ops = 8 * n_valid * H
    cd_bytes = 2 if bf16 else 4
    nbytes = cd_bytes * (2 * B * A * H + (2 * H + 1) * H + H * H + 2 * H) \
        + 4 * (B * A * 3 + 2 * B * E + 3 * B * A * H + B * A)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_gemm = gemm_ops / BF16_FLOPS if bf16 else 3 * gemm_ops / TF32_FLOPS
    t_tc = (t_gemm + edge_ops / FP32_FLOPS) * 1e3
    t_ffma = (gemm_ops + edge_ops) / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "bound_ffma_ms": max(t_ffma, t_bytes),
            "operations": gemm_ops + edge_ops, "bytes": nbytes}


def _edge_fwd_inputs(torch, g, dev, B, A, E, H=866):
    """Seeded inputs of one forward call at (B, A, E, H): h, pos, φ_e as
    ``mlp_init`` draws it (biases of 0.1 scale) and edges."""
    import numpy as np

    from repro_torch.models.mlp import mlp_init
    phi = mlp_init(np.random.default_rng(B * 1000 + A), 2 * H + 1, H, H, 1,
                   device=dev)
    phi["fc0"]["b"] = 0.1 * torch.randn(H, generator=g, device=dev)
    phi["fc1"]["b"] = 0.1 * torch.randn(H, generator=g, device=dev)
    h = torch.randn((B, A, H), generator=g, device=dev)
    pos = 2.0 * torch.randn((B, A, 3), generator=g, device=dev)
    return h, pos, *edge_case(torch, B, E, A, g, dev), phi


def _edge_fwd_call(torch, h, pos, src, dst, em, phi, splits=None):
    """A closure that calls #3's launcher (``ops._launch_fwd``) once on
    routed int32 edges, as the autograd Function does, in h's dtype (the
    φ_e leaves already in it, so the call casts nothing), with the
    forward's planned blocks; returns (out, Pi, Pj, S, deg)."""
    from repro_torch.kernels.egnn_edge import ops
    B, A, H = h.shape
    E = src.shape[1]
    sr = torch.where(em, src, A).to(torch.int32).contiguous()
    dr = torch.where(em, dst, A).to(torch.int32).contiguous()
    blocks = ops._resolve_blocks(None, None, A, E, H)
    w = (phi["fc0"]["w"], phi["fc0"]["b"], phi["fc1"]["w"], phi["fc1"]["b"])
    kw = {} if splits is None else {"splits": splits}

    def call():
        return ops._launch_fwd(h, pos, sr, dr, *w, h.dtype, *blocks, **kw)
    return call


def _edge_fwd_plain(torch, h, pos, src, dst, em, phi, dtype=None):
    """The plain forward's outputs and scratch, (out, Pi, Pj, S, deg), from
    the node-projection algebra in plain PyTorch (``dtype``: float32, or
    float64 for an exact yardstick); ``out`` is ``egnn_edge_agg_ref``."""
    from repro_torch.kernels.egnn_edge import egnn_edge_agg_ref
    dt = dtype or torch.float32
    H = h.shape[-1]
    A = h.shape[1]
    cast = {k: {n: t.to(dt) for n, t in v.items()} for k, v in phi.items()}
    h, pos = h.to(dt), pos.to(dt)
    out = egnn_edge_agg_ref(h, pos, src, dst, em, cast)
    w0, b0 = cast["fc0"]["w"], cast["fc0"]["b"]
    pi, pj = h @ w0[:H] + b0, h @ w0[H:2 * H]
    valid = em & (dst < A)
    sc, dc = src.clamp(max=A - 1), dst.clamp(max=A - 1)

    def gather(x, i):
        return torch.take_along_dim(x, i[..., None], dim=1)
    d2 = ((gather(pos, sc) - gather(pos, dc)) ** 2).sum(-1, keepdim=True)
    z = gather(pi, sc) + gather(pj, dc) + d2 * w0[2 * H]
    s_e = z * torch.sigmoid(z) * valid[..., None]
    idx = torch.where(valid, dst, 0)
    # lint: allow(ATM001): a plain version, held within a tol
    S = torch.zeros_like(h).scatter_add_(1, idx[..., None].expand_as(s_e),
                                         s_e)
    # lint: allow(ATM001): a plain version, held within a tol
    deg = torch.zeros(h.shape[:2], dtype=dt, device=h.device).scatter_add_(
        1, idx, valid.to(dt))
    return out, pi, pj, S, deg


def _fwd_rel_errs(torch, got, want) -> dict:
    """Each of (out, Pi, Pj, S, deg)'s largest error over its largest
    entry."""
    return {n: float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-30))
            for n, a, b in zip(("out", "Pi", "Pj", "S", "deg"), got, want)}


def _fwd_gemm_library(torch, B, A, H, g, dev, dtype=None):
    """#3's three node-level products as ``torch.matmul`` calls in
    ``dtype`` (f32 with TF32 off, bf16 with f32 reduction, as
    ``repro_torch`` pins them): a yardstick for the GEMM part only, never
    used by the port."""
    dt = dtype or torch.float32
    hm, sm = (torch.randn((B * A, H), generator=g, device=dev).to(dt)
              for _ in range(2))
    w0i, w0j, w1 = (torch.randn((H, H), generator=g, device=dev).to(dt)
                    for _ in range(3))

    def library():
        hm @ w0i                                # Pi (b0 aside)
        hm @ w0j                                # Pj
        sm @ w1                                 # agg (deg ⊗ b1 aside)
    return library


EDGE_CASES = [("train", 40, 64, 2048), ("b8", 8, 64, 2048),
              ("b4", 4, 64, 2048), ("b2", 2, 64, 2048),
              ("b8_a16", 8, 16, 512), ("bucket", 40, 32, 128),
              ("ragged", 3, 40, 1000)]
EDGE_TIMED = ("train", "b8", "b4", "b2")


def check_egnn_edge(torch, dev, g, cd=None):
    """#3 through ``egnn_edge_agg`` in the compute dtype ``cd`` (None: f32;
    bf16 within ``EDGE_BF16_TOL``) against ``egnn_edge_agg_ref`` in it at
    ``EDGE_CASES``: the training path's shape (B=40: 5 sources x 8 graphs
    in one trunk pass), the serve batch's B=8 (A=64, and the bucket A=16,
    E=512: M = 128), B=4 (a task-parallel rank's, and a serve batch split
    over 2 entries), B=2 (split over 4), the training bucket (40, 32, 128)
    and a ragged shape. Two calls must give the same bits, each launching
    the kernel of its dtype once (``egnn_edge_agg.launches``, or
    ``.bf16``). In bf16 the kernel's and the plain version's error against
    a float64 forward on the same bf16 values are recorded. At
    ``EDGE_TIMED`` the launcher's scratch (Pi, Pj, S, deg: what the
    backward reads) and, in f32, its output are held per output against
    the plain versions (in bf16 that float64 forward) within ``EDGE_TOL``,
    and #3 is timed by device time with its kernels a call (at most 4; 3
    in bf16), beside ``torch.matmul`` of its three products in its dtype
    (``gemm_library_ms``) and, in bf16, the f32 #3 (``f32_ms``)."""
    from repro_torch.kernels.egnn_edge import (egnn_edge_agg,
                                               egnn_edge_agg_ref, gemm_plan)
    H = 866
    bf16 = cd == torch.bfloat16
    tol = EDGE_BF16_TOL if bf16 else EDGE_TOL
    kw = {"compute_dtype": cd} if bf16 else {}
    worst, out = 0.0, {}
    for name, B, A, E in EDGE_CASES:
        h32, pos, src, dst, em, phi = _edge_fwd_inputs(torch, g, dev, B, A, E)
        h = h32.bfloat16() if bf16 else h32
        before = (egnn_edge_agg.launches, egnn_edge_agg.bf16.launches)
        got = egnn_edge_agg(h, pos, src, dst, em, phi, **kw)
        again = egnn_edge_agg(h, pos, src, dst, em, phi, **kw)
        if (egnn_edge_agg.launches - before[0],
                egnn_edge_agg.bf16.launches - before[1]) != \
                ((0, 2) if bf16 else (2, 0)):
            fail(f"egnn_edge {cd} {name}: a call launched another kernel "
                 f"than #3 in its compute dtype")
        ref = egnn_edge_agg_ref(h, pos, src, dst, em, phi, **kw)
        # lint: allow(TRC003): each case's check reads back anyway
        torch.cuda.synchronize()
        if got.dtype != h.dtype or not torch.equal(got, again):
            fail(f"egnn_edge {cd} {name}: out in {got.dtype}, or two calls "
                 f"differ bitwise")
        err, scale = scaled_err(torch, got, ref)
        if not err <= tol * scale:
            fail(f"egnn_edge {cd} {name}: max_abs_err {err} > {tol}*{scale}")
        worst = max(worst, err)
        case = {"shape": [B, A, E, H], "max_abs_err": err}
        # φ_e's leaves in the compute dtype, as the op casts them (so the
        # timed launch casts nothing); in bf16 the float64 forward runs on
        # those values
        cphi = {k: {n: t.to(h.dtype) for n, t in v.items()}
                for k, v in phi.items()}
        if bf16:
            exact = _edge_fwd_plain(torch, h, pos, src, dst, em, cphi,
                                    dtype=torch.float64)
            e64 = float(exact[0].abs().max().clamp_min(1.0))
            case["kernel_vs_f64"] = float(
                (got.double() - exact[0]).abs().max()) / e64
            case["plain_vs_f64"] = float(
                (ref.double() - exact[0]).abs().max()) / e64
        del got, again, ref
        if name not in EDGE_TIMED:
            out[name] = case
            continue
        call = _edge_fwd_call(torch, h, pos, src, dst, em, cphi)
        errs = _fwd_rel_errs(torch, call(), exact if bf16 else
                             _edge_fwd_plain(torch, h, pos, src, dst, em,
                                             phi))
        if bf16:
            del errs["out"]            # bf16: held above within tol
        for n, e in errs.items():
            if not e <= EDGE_TOL:
                fail(f"egnn_edge {cd} {name} {n}: relative error {e} > "
                     f"{EDGE_TOL}")
        prof = device_profile(torch, call)
        most = 3 if bf16 else 4
        if prof["kernels_per_call"] > most:
            fail(f"egnn_edge {cd} {name}: {prof['kernels_per_call']} "
                 f"kernels a call, the design has at most {most}")
        n_valid = int(em.sum())
        case.update({
            "ms": prof["ms"], "by_kernel": prof["by_kernel"],
            "kernels_per_call": prof["kernels_per_call"],
            "wall_ms": time_ms(torch, call),
            "plain_ms": device_ms(torch, lambda: egnn_edge_agg_ref(
                h, pos, src, dst, em, phi, **kw), iters=3, warm=1),
            "library_ms": None,
            "library_note": "no one PyTorch call computes this forward",
            "gemm_library_ms": device_ms(torch, _fwd_gemm_library(
                torch, B, A, H, g, dev, cd)),
            "valid_edges": n_valid, "rel_err": errs,
            **_edge_fwd_bound(B, A, E, H, n_valid, bf16)})
        if bf16:
            case["f32_ms"] = device_ms(torch, _edge_fwd_call(
                torch, h32, pos, src, dst, em, phi))
        else:
            case["splits"] = list(gemm_plan.fwd_splits(B * A, H))
        if name == "train":
            out.update(case)
        else:
            out[name] = case
    out["max_abs_err"] = worst
    return out


def _edge_bwd_inputs(torch, g, dev, B, A, E, H=866):
    """Seeded leaves (h, pos, fc0 w/b, fc1 w/b), edges and the upstream
    cotangent of one edge-path call at (B, A, E, H)."""
    def t(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)
                ).requires_grad_(True)
    w0, b0 = t(2 * H + 1, H, scale=(2 * H + 1) ** -0.5), t(H, scale=0.1)
    w1, b1 = t(H, H, scale=H ** -0.5), t(H, scale=0.1)
    h, pos = t(B, A, H), t(B, A, 3, scale=2.0)
    src, dst, em = edge_case(torch, B, E, A, g, dev)
    gup = torch.randn((B, A, H), generator=g, device=dev)
    return [h, pos, w0, b0, w1, b1], (src, dst, em), gup


def _edge_bwd_call(torch, leaves, edges, gup, need_dpos):
    """A closure that calls #4's wrapper (``ops.egnn_edge_bwd``) once on the
    forward kernel's scratch for these inputs, as the autograd Function
    does, with the backward's planned blocks; and the routed src/dst."""
    from repro_torch.kernels.egnn_edge import ops
    h, pos, w0, b0, w1, b1 = (x.detach() for x in leaves)
    src, dst, em = edges
    B, A, H = h.shape
    E = src.shape[1]
    sr = torch.where(em, src, A).to(torch.int32).contiguous()
    dr = torch.where(em, dst, A).to(torch.int32).contiguous()
    fwd = ops._resolve_blocks(None, None, A, E, H)
    _, pi, pj, s, deg = ops._launch_fwd(h, pos, sr, dr, w0, b0, w1, b1,
                                        torch.float32, *fwd)
    be, bh = ops._resolve_blocks(None, None, A, E, H, bwd=True)

    def call():
        return ops.egnn_edge_bwd(gup, h, pos, sr, dr, w0, w1, pi, pj, s, deg,
                                 block_e=be, block_h=bh, need_dpos=need_dpos)
    return call, sr, dr


def _edge_bwd_bounds(B, A, E, H, n_valid, need_dpos, bf16=False):
    """#4's least time on the card for these inputs: its six node-level
    products (2·B·A·H² each) on the tensor cores in the fewest passes that
    give each to the f32 contract, plus ~15 operations per valid edge and
    column at the fp32 peak (``bound_ms``); the same work all in fp32 FFMA
    (``bound_ffma_ms``); and the bytes (inputs g, h, Pi, Pj, S, deg, pos,
    src, dst and the weights read once, g, h and the weights 2 bytes a
    value in bf16, outputs written once, f32) at HBM speed; each bound the
    larger of its operations time and the bytes time. On f32 inputs a
    product takes three TF32 passes (the 3xTF32 split). On bf16 g, h and
    weights (``bf16``) a bf16 value's TF32 lo part is zero: the five
    products that mix an f32 operand with a bf16 one (S·g, h·dPi, h·dPj,
    dPi·w0i, dPj·w0j) need two TF32 passes each, and g·w1ᵀ (bf16 by bf16)
    one pass at the bf16 rate; the kernel runs three TF32 passes of each
    all the same (its bits are the f32 launch's)."""
    prod = 2 * B * A * H * H
    gemm_ops = 6 * prod
    edge_ops = 15 * n_valid * H
    w_bytes = (2 * H + 1) * H + H * H
    dpos = B * A * 3 if need_dpos else 0
    in_bytes = 2 if bf16 else 4
    nbytes = in_bytes * (2 * B * A * H + w_bytes) + 4 * (
        3 * B * A * H + B * A + B * A * 3 + 2 * B * E + B * A * H + dpos
        + w_bytes + 2 * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_gemm = (5 * 2 * prod / TF32_FLOPS + prod / BF16_FLOPS if bf16
              else 3 * gemm_ops / TF32_FLOPS)
    t_tc = (t_gemm + edge_ops / FP32_FLOPS) * 1e3
    t_ffma = (gemm_ops + edge_ops) / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_tc, t_bytes),
            "bound_by": "operations" if t_tc >= t_bytes else "bytes",
            "bound_ffma_ms": max(t_ffma, t_bytes),
            "operations": gemm_ops + edge_ops, "bytes": nbytes}


def _gemm_library(torch, B, A, H, g, dev, dtype=None):
    """The six node-level products of #4 as ``torch.matmul`` calls (TF32
    off, as ``repro_torch`` pins it; in ``dtype``, f32 by default): a
    yardstick for the GEMM part only, never used by the port."""
    M = B * A
    dt = dtype or torch.float32
    x = [torch.randn((M, H), generator=g, device=dev).to(dt)
         for _ in range(5)]
    gm, sm, hm, dpi, dpj = x
    w0i, w0j, w1 = (torch.randn((H, H), generator=g, device=dev).to(dt)
                    for _ in range(3))

    def library():
        gm @ w1.T                               # dS
        sm.T @ gm                               # dw1
        dpi @ w0i.T + dpj @ w0j.T               # dh
        hm.T @ dpi                              # dw0i
        hm.T @ dpj                              # dw0j
    return library


def check_egnn_edge_bwd(torch, dev, g):
    """The backward kernel through ``egnn_edge_agg``'s autograd Function
    against ``egnn_edge_bwd_ref``, per output, at the training path's shape
    (B=40: 5 sources x 8 graphs in one trunk pass, pos needing no gradient),
    at the serve batch's B=8 with dpos, at a task-parallel rank's B=4
    without, and at a ragged shape; two backward calls must give the same
    bits. #4 is timed by device time at B=40, B=8 and B=4, with its kernels
    a call (at most 3 without dpos, 4 with)."""
    from repro_torch.kernels.egnn_edge import egnn_edge_agg, gemm_plan, ops
    from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
    H = 866
    names = ("dh", "dpos", "dw0", "db0", "dw1", "db1")
    cases = [("train", 40, 64, 2048, False), ("b8", 8, 64, 2048, True),
             ("b4", 4, 64, 2048, False), ("ragged", 3, 40, 1000, True)]
    worst, out = 0.0, {}
    for name, B, A, E, need_dpos in cases:
        leaves, edges, gup = _edge_bwd_inputs(torch, g, dev, B, A, E, H)
        h, pos, w0, b0, w1, b1 = leaves
        src, dst, em = edges
        phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
        wrt = leaves if need_dpos else [h, w0, b0, w1, b1]
        agg = egnn_edge_agg(h, pos if need_dpos else pos.detach(), src, dst,
                            em, phi)

        def bwd():
            return torch.autograd.grad(agg, wrt, gup, retain_graph=True)
        got = bwd()
        again = bwd()
        # lint: allow(TRC003): each case's check reads back anyway
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"egnn_edge_bwd {name}: two calls differ bitwise")
        if not need_dpos:
            got = got[:1] + (None,) + got[1:]
        sr = torch.where(em, src, A)
        dr = torch.where(em, dst, A)
        d = [x.detach() for x in leaves]

        def plain():
            return egnn_edge_bwd_ref(gup, d[0], d[1], sr, dr, d[2][:H],
                                     d[2][H:2 * H], d[2][2 * H:],
                                     d[3][None], d[4])
        dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1 = plain()
        want = [dh, dpos, torch.cat([dw0i, dw0j, dw0d]), db0[0], dw1, db1[0]]
        errs = {}
        for n, a, b in zip(names, got, want):
            if a is None:
                continue
            err = float((a - b).abs().max())
            scale = float(b.abs().max())
            if not err <= BWD_TOL * scale:
                fail(f"egnn_edge_bwd {name} {n}: max_abs_err {err} > "
                     f"{BWD_TOL}*{scale}")
            errs[n] = err / scale
            worst = max(worst, err)
        del want, dh, dpos, dw0i, dw0j
        if name == "ragged":
            out["ragged_rel_err"] = errs
            continue
        call, _, _ = _edge_bwd_call(torch, leaves, edges, gup, need_dpos)
        prof = device_profile(torch, call)
        most = 4 if need_dpos else 3
        if prof["kernels_per_call"] > most:
            fail(f"egnn_edge_bwd {name}: {prof['kernels_per_call']} kernels "
                 f"a call, the design has at most {most}")
        n_valid = int(em.sum())
        case = {"ms": prof["ms"], "by_kernel": prof["by_kernel"],
                "kernels_per_call": prof["kernels_per_call"],
                "wall_ms": time_ms(torch, call),
                "plain_ms": time_ms(torch, plain, iters=3, warm=1),
                "library_ms": None,
                "library_note": "no one PyTorch call computes this backward",
                "gemm_library_ms": device_ms(
                    torch, _gemm_library(torch, B, A, H, g, dev)),
                "shape": [B, A, E, H], "dpos": need_dpos,
                "valid_edges": n_valid, "rel_err": errs,
                **_edge_bwd_bounds(B, A, E, H, n_valid, need_dpos)}
        if name == "train":
            case["w1_splits"] = gemm_plan.w1_splits(B * A, H)
            plan = gemm_plan.launches(B, A, H)
            case["gemm_items"] = [gemm_plan.launch_items(x) for x in plan]
            case["gemm_makespan_ksteps"] = [
                gemm_plan.makespan(gemm_plan.launch_ksteps(x)) for x in plan]
            case["gemm_slots"] = (ops.gemm_blocks_per_sm()
                                  * torch.cuda.get_device_properties(0)
                                  .multi_processor_count)
            out.update(case)
        else:
            out[name] = case
        del agg, got, again
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

def serve_rel_err(a, b) -> float:
    """The largest difference of served rows ``a`` from ``b``, energies and
    forces, each over max(1, |b|)."""
    e = max(abs(x["energy"] - y["energy"]) /
            max(1.0, abs(y["energy"])) for x, y in zip(a, b))
    f = max(float(abs(x["forces"] - y["forces"]).max()) /
            max(1.0, float(abs(y["forces"]).max())) for x, y in zip(a, b))
    return max(e, f)


def rows_bitwise(a, b) -> bool:
    return all(x["energy"] == y["energy"] and
               x["forces"].shape == y["forces"].shape and
               bool((x["forces"] == y["forces"]).all()) for x, y in zip(a, b))


def serve_pass(torch, impl, params, spec, samples, heads, counters,
               cfg=None):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.serve import ServeSession
    cfg = (cfg or CONFIG).replace(segment_sum_impl=impl)
    with ServeSession(params, cfg, spec=spec, max_batch=8, max_wait_ms=20.0,
                      device="cuda") as srv:
        t0 = time.perf_counter()
        n_shapes = srv.warmup()
        warm_s = time.perf_counter() - t0
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        futs = srv.submit_many(samples, heads)
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        snap = srv.stats()
        for r, s in zip(res, samples):
            n = int(s["node_mask"].sum())
            if not (math.isfinite(r["energy"]) and r["forces"].shape == (n, 3)
                    and bool(torch.isfinite(torch.from_numpy(
                        r["forces"])).all())):
                fail(f"{impl}: non-finite or misshapen result")
        for i in range(0, len(samples), max(1, len(samples) // 4)):
            one = srv.predict_one(samples[i], head=heads[i])
            if not (one["energy"] == res[i]["energy"] and
                    (one["forces"] == res[i]["forces"]).all()):
                fail(f"{impl}: batched row {i} not bitwise equal to "
                     f"predict_one")
    c = snap["counters"]
    return res, {"impl": impl, "requests": len(res),
                 "batches": c["batches"], "launches": launches,
                 "shapes": n_shapes, "warmup_s": warm_s, "wall_s": wall,
                 "requests_per_s": len(res) / wall,
                 "e2e_ms": {k: snap["latency"]["e2e"][k]
                            for k in ("p50_ms", "p99_ms")},
                 "compute_ms": {k: snap["latency"]["compute"][k]
                                for k in ("p50_ms", "p99_ms")}}


def serve_inputs(n_requests):
    """The serving phases' seeded inputs: five synthetic sources, the bucket
    grid planned from them, hydragnn-gfm params (seed 0) and
    ``n_requests`` mixed-head requests, source by source in turn."""
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.data.bucketing import BucketSpec
    from repro_torch.data.synthetic_atoms import (generate_mixture,
                                                  source_dicts)
    sources = source_dicts(generate_mixture(200, max_atoms=64,
                                            max_edges=2048, seed=0))
    spec = BucketSpec.from_sources(sources)
    params = gfm_mtl_init(CONFIG, CONFIG.n_tasks, seed=0)
    samples, heads = [], []
    for i in range(n_requests):
        t = i % len(sources)
        s = sources[t]
        j = (i // len(sources)) % s["species"].shape[0]
        samples.append({k: v[j] for k, v in s.items()})
        heads.append(t)
    return spec, params, samples, heads


def serve_phase(torch, n_requests):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.serve import ServeSession

    spec, params, samples, heads = serve_inputs(n_requests)
    counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                "segment_sum": ss_ops.segment_sum}
    res_f, info_f = serve_pass(torch, "fused", params, spec, samples, heads,
                               counters)
    res_p, info_p = serve_pass(torch, "pallas", params, spec, samples, heads,
                               counters)
    if not (info_f["launches"]["egnn_edge"] == 4 * info_f["batches"] > 0
            and info_f["launches"]["segment_sum"] == 0):
        fail(f"fused pass launch counts {info_f['launches']} vs "
             f"{info_f['batches']} batches")
    if not (info_p["launches"]["segment_sum"] == 4 * info_p["batches"] > 0
            and info_p["launches"]["egnn_edge"] == 0):
        fail(f"pallas pass launch counts {info_p['launches']} vs "
             f"{info_p['batches']} batches")

    fused_vs_pallas = serve_rel_err(res_f, res_p)
    if not fused_vs_pallas <= SERVE_TOL:
        fail(f"fused vs pallas serve results differ: {fused_vs_pallas}")
    # the plain forward (one-hot segment-sum, no kernel) on a few requests
    idx = list(range(0, n_requests, max(1, n_requests // 8)))
    with ServeSession(params, CONFIG.replace(segment_sum_impl="jnp"),
                      spec=spec, max_batch=8, device="cuda") as plain:
        res_plain = [plain.predict_one(samples[i], head=heads[i])
                     for i in idx]
    vs_plain = serve_rel_err([res_f[i] for i in idx], res_plain)
    if not vs_plain <= SERVE_TOL:
        fail(f"fused serve results differ from the plain forward: {vs_plain}")
    return {"phase": "serve", "config": "hydragnn-gfm", "heads":
            CONFIG.n_tasks, "bucket_spec": [list(spec.atom_buckets),
                                            list(spec.edge_buckets)],
            "fused": info_f, "pallas": info_p,
            "fused_vs_pallas_rel_err": fused_vs_pallas,
            "fused_vs_plain_rel_err": vs_plain, "tolerance": SERVE_TOL}, \
        res_f


# ---------------------------------------------------------------------------
# phase 3b: serving scale-out at full width
# ---------------------------------------------------------------------------

SCALEOUT_REQUESTS = 160              # mixed-head requests of (a) and (d)
SCALEOUT_REPLICAS = 8                # (a): replicas on the one card
SHARD_WAYS = (2, 4)                  # (d): mesh entries a batch splits over


def _served(futs) -> list:
    return [f.result(timeout=600) for f in futs]


def _crash_replica(rep, r, sample):
    """Crash replica ``r`` as tests/test_serve_scaleout.py does: its next
    ``batcher.add`` raises and the worker's handler closes its queue; the
    trigger request must fail. Waits until the queue is closed."""
    def boom(req):
        raise RuntimeError(f"injected fault in replica {r}")
    rep.replicas[r].batcher.add = boom
    err = rep.submit(sample, head=r % rep.n_heads).exception(timeout=600)
    if not isinstance(err, RuntimeError):
        fail(f"serve_scaleout (b): replica {r}'s trigger gave {err!r}")
    deadline = time.monotonic() + 60.0
    while not rep.replicas[r].queue.closed:
        if time.monotonic() > deadline:
            fail(f"serve_scaleout (b): replica {r}'s queue never closed")
        time.sleep(0.005)


SESSION_CYCLES = 5                  # (e): open-use-close cycles


def _session_cycles(torch, params, cfg, spec, samples, heads, refs):
    """(e) ``SESSION_CYCLES`` cycles of an 8-replica session opened,
    warmed up, serving 40 requests (rows bitwise to ``refs``) and closed:
    the bytes allocated on the card after each cycle (garbage collected,
    the cached blocks returned), which hold the cuBLAS workspaces of every
    (handle, stream) pair that ran a GEMM. The serving streams come from a
    pool keyed by the thread's cuBLAS handle, so the cycles after the
    first add none: each cycle's bytes must stay at the first's."""
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.serve import ReplicaServeSession
    from repro_torch.serve.engine import STREAMS
    after, pool, ok = [], [], True
    for _ in range(SESSION_CYCLES):
        with ReplicaServeSession(
                params, cfg, spec=spec, max_batch=8, max_wait_ms=5.0,
                meshes=make_replica_meshes(
                    SCALEOUT_REPLICAS,
                    devices=[DEVICE] * SCALEOUT_REPLICAS)) as rep:
            rep.warmup()
            ok = ok and rows_bitwise(_served(rep.submit_many(
                samples[:40], heads[:40])), refs[:40])
        del rep
        _free(torch)
        after.append(torch.cuda.memory_allocated())
        pool.append(len(STREAMS))
    checks = {"rows_bitwise": ok,
              "bytes_at_first_cycle": max(after) == after[0]}
    if not all(checks.values()):
        fail(f"serve_scaleout (e): {checks}, allocated bytes after each "
             f"cycle {after}, pool streams {pool}")
    return {"cycles": SESSION_CYCLES, "replicas": SCALEOUT_REPLICAS,
            "checks": checks, "allocated_bytes_after_cycle": after,
            "pool_streams_after_cycle": pool}


def serve_scaleout_phase(torch, serve, counters):
    """Multi-device serving on the one card at full width: (a) 8 replicas
    (8 streams, 8 param copies) behind the router; (b) failover, every
    replica dead, ``restart_workers``; (c) close under load; (d) rows split
    over 2 and 4 entries under ``"fused"`` and ``"pallas"``; (e) sessions
    opened and closed five times leave the card's allocated bytes (the
    cuBLAS workspaces) at the first cycle's. ``counters`` are zeroed just
    before (a)'s and each (d) run's requests."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.serve import (ReplicaServeSession, ServeClosedError,
                                   ServeSession)
    spec, params, samples, heads = serve_inputs(SCALEOUT_REQUESTS)
    cards = lambda n: [DEVICE] * n                       # noqa: E731
    single = {}
    for impl in ("fused", "pallas"):
        with ServeSession(params, CONFIG.replace(segment_sum_impl=impl),
                          spec=spec, max_batch=8, device=DEVICE) as one:
            single[impl] = [one.predict_one(s, head=h)
                            for s, h in zip(samples, heads)]
    refs = single["fused"]
    cfg = CONFIG.replace(segment_sum_impl="fused")
    out = {"phase": "serve_scaleout", "config": "hydragnn-gfm",
           "requests": SCALEOUT_REQUESTS, "tolerance": SERVE_TOL}

    # (a) replicas
    rep = ReplicaServeSession(
        params, cfg, spec=spec, max_batch=8, max_wait_ms=20.0,
        meshes=make_replica_meshes(SCALEOUT_REPLICAS,
                                   devices=cards(SCALEOUT_REPLICAS)))
    with rep:
        t0 = time.perf_counter()
        shapes = rep.warmup()
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        firsts = [next(iter(interop.leaves(s._entries[0].shared).values()))
                  for s in rep.replicas]
        storages = {t.untyped_storage().data_ptr() for t in firsts}
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = _served(rep.submit_many(samples, heads))
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        st = rep.stats()
        # each replica's worker ran on one stream of the pool, no two
        # workers on one
        worker_streams = [s.worker_streams for s in rep.replicas]
    c = st["counters"]
    checks = {
        "rows_bitwise_vs_single": rows_bitwise(res, refs),
        "routed": c["routed"] == SCALEOUT_REQUESTS,
        "outstanding_zero": st["scheduler"]["outstanding"]
        == [0] * SCALEOUT_REPLICAS,
        "param_storages": len(storages) == SCALEOUT_REPLICAS,
        "streams": all(len(w) == 1 for w in worker_streams)
        and len(set().union(*worker_streams)) == SCALEOUT_REPLICAS,
        "launches": launches["egnn_edge"] == 4 * c["batches"] > 0
        and launches["segment_sum"] == 0,
        "shapes": shapes <= spec.n_shapes * SCALEOUT_REPLICAS}
    if not all(checks.values()):
        fail(f"serve_scaleout (a): {checks}, launches {launches}, "
             f"{c['batches']} batches")
    fused = serve["fused"]
    out["a_replicas"] = {
        "replicas": SCALEOUT_REPLICAS, "impl": "fused", "checks": checks,
        "batches": c["batches"], "launches": launches, "shapes": shapes,
        "warmup_s": warm_s, "wall_s": wall,
        "requests_per_s": SCALEOUT_REQUESTS / wall,
        "e2e_ms": {k: st["latency"]["e2e"][k] for k in ("p50_ms", "p99_ms")},
        "compute_ms": {k: st["latency"]["compute"][k]
                       for k in ("p50_ms", "p99_ms")},
        "plan": st["plan"],
        "serve_fused_pass": {k: fused[k] for k in ("requests", "wall_s",
                                                   "requests_per_s",
                                                   "e2e_ms")}}

    # (b) failover, every replica dead, recovery
    rep = ReplicaServeSession(params, cfg, spec=spec, max_batch=8,
                              max_wait_ms=1.0,
                              meshes=make_replica_meshes(2, devices=cards(2)))
    with rep:
        sm, h = samples[0], heads[0]            # head 0: replica 0's key
        _crash_replica(rep, 0, sm)
        got = rep.submit(sm, head=h).result(timeout=600)
        failover_ok = rows_bitwise([got], [refs[0]]) and \
            0 in rep.scheduler.dead and rep.metrics.counters["failovers"] >= 1
        _crash_replica(rep, 1, sm)
        try:
            rep.submit(sm, head=h)
            all_dead_raises = False
        except ServeClosedError:
            all_dead_raises = True
        restarted = rep.restart_workers()
        after = _served(rep.submit_many(samples[:16], heads[:16]))
        recovered_ok = rows_bitwise(after, refs[:16])
        st = rep.stats()
    checks = {"failover_bitwise": failover_ok,
              "all_dead_raises": all_dead_raises,
              "restarted": restarted == 2,
              "recovered_bitwise": recovered_ok}
    if not all(checks.values()):
        fail(f"serve_scaleout (b): {checks}")
    out["b_failover"] = {"replicas": 2, "checks": checks,
                         "failovers": st["counters"]["failovers"],
                         "worker_failures": st["counters"]["worker_failures"],
                         "worker_restarts": st["counters"]["worker_restarts"]}

    # (c) close under load
    rep = ReplicaServeSession(
        params, cfg, spec=spec, max_batch=8, max_wait_ms=100.0,
        meshes=make_replica_meshes(SCALEOUT_REPLICAS,
                                   devices=cards(SCALEOUT_REPLICAS)))
    burst = rep.submit_many(samples[:40], heads[:40])
    t0 = time.perf_counter()
    rep.close()
    close_s = time.perf_counter() - t0
    try:
        rep.submit(samples[0], head=heads[0])
        after_close = "accepted"
    except ServeClosedError as e:
        after_close = type(e).__name__
    checks = {"all_done": all(f.done() for f in burst),
              "all_ok": all(f.exception() is None for f in burst),
              "rows_bitwise": rows_bitwise([f.result() for f in burst
                                            if f.exception() is None],
                                           refs[:40]),
              "after_close": after_close == "ServeClosedError"}
    if not all(checks.values()):
        fail(f"serve_scaleout (c): {checks}")
    out["c_close"] = {"requests": 40, "checks": checks, "close_s": close_s}

    # (d) a bin's rows split over a mesh of entries on the card
    out["d_sharded"] = []
    for impl, counter in (("fused", "egnn_edge"), ("pallas", "segment_sum")):
        cfg_i = CONFIG.replace(segment_sum_impl=impl)
        for n in SHARD_WAYS:
            mesh = make_replica_meshes(1, devices_per_replica=n,
                                       devices=cards(n))[0]
            with ServeSession(params, cfg_i, spec=spec, max_batch=8,
                              mesh=mesh, max_wait_ms=20.0) as sh:
                sh.warmup()
                # lint: allow(TRC003): the timed requests start on an idle card
                torch.cuda.synchronize()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                res = _served(sh.submit_many(samples, heads))
                wall = time.perf_counter() - t0
                launches = {k: c.launches for k, c in counters.items()}
                st = sh.stats()
                own = [sh.predict_one(s, head=h)
                       for s, h in zip(samples, heads)]
            try:
                ServeSession(params, cfg_i, spec=spec, max_batch=6,
                             mesh=make_replica_meshes(
                                 1, devices_per_replica=4,
                                 devices=cards(4))[0])
                uneven_raises = False
            except ValueError:
                uneven_raises = True
            b = st["counters"]["batches"]
            other = "segment_sum" if counter == "egnn_edge" else "egnn_edge"
            vs_single = serve_rel_err(res, single[impl])
            checks = {"rows_bitwise_vs_own": rows_bitwise(res, own),
                      "within_tol_of_single": vs_single <= SERVE_TOL,
                      "plan": st["plan"]["mode"] == "sharded"
                      and st["plan"]["devices"] == n,
                      "launches": launches[counter] == 4 * n * b > 0
                      and launches[other] == 0,
                      "uneven_raises": uneven_raises}
            if not all(checks.values()):
                fail(f"serve_scaleout (d) {impl} n={n}: {checks}, "
                     f"launches {launches}, {b} batches, vs single "
                     f"{vs_single}")
            out["d_sharded"].append({
                "impl": impl, "entries": n, "rows_a_chunk": 8 // n,
                "checks": checks, "batches": b, "launches": launches,
                "bitwise_vs_single": rows_bitwise(res, single[impl]),
                "rel_err_vs_single": vs_single, "wall_s": wall,
                "requests_per_s": SCALEOUT_REQUESTS / wall,
                "e2e_ms": {k: st["latency"]["e2e"][k]
                           for k in ("p50_ms", "p99_ms")}})
    out["e_workspaces"] = _session_cycles(torch, params, cfg, spec, samples,
                                          heads, refs)
    out["launches"] = {
        "egnn_edge": out["a_replicas"]["launches"]["egnn_edge"] + sum(
            d["launches"]["egnn_edge"] for d in out["d_sharded"]),
        "segment_sum": sum(d["launches"]["segment_sum"]
                           for d in out["d_sharded"])}
    return out


# ---------------------------------------------------------------------------
# phase 4: training at full width
# ---------------------------------------------------------------------------

def _embed_order_sum(torch, g, ids, V):
    """#1's function by plain PyTorch in #1's own order: each row's f32
    sum of its cotangent rows in token order, from 0, rounded once to g's
    dtype (one elementwise add for each rank within an id)."""
    ids = ids.long()
    sid, order = torch.sort(ids, stable=True)
    uniq, counts = torch.unique_consecutive(sid, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    gf = g.float()
    acc = torch.zeros((uniq.numel(), g.shape[1]), dtype=torch.float32,
                      device=g.device)
    for r in range(int(counts.max())):
        live = counts > r
        acc[live] = acc[live] + gf[order[start[live] + r]]
    out = torch.zeros((V, g.shape[1]), dtype=torch.float32, device=g.device)
    out[uniq] = acc
    return out.to(g.dtype)


def _capture_embed(fn):
    """``fn()`` with every call of ``kernels.segment_sum`` recorded (the
    name the embedding's backward imports when it runs): fn's result and
    each call's (cotangent, ids, rows, output)."""
    from repro_torch.kernels import segment_sum as ss_pkg
    seen, real = [], ss_pkg.segment_sum

    def capture(messages, dst, n_nodes, **kw):
        out = real(messages, dst, n_nodes, **kw)
        seen.append((messages.detach().clone(), dst.clone(), n_nodes,
                     out.clone()))
        return out
    ss_pkg.segment_sum = capture
    try:
        return fn(), seen
    finally:
        ss_pkg.segment_sum = real


def _check_embed(torch, calls, what):
    """#1 on a training step's own embedding cotangent (``_capture_embed``
    of the step: one call), in the step's dtype and launched again on the
    cotangent in the other one (f32 <-> bf16): bitwise equal to
    ``_embed_order_sum``, and within the two orders' rounding bound of
    the one-hot plain version (``segment_sum_ref``): 2 n u sum|g| for an
    id of n rows, u = 2^-24, plus one bf16 rounding (2^-7 |ref|) in
    bf16. ``rel_err`` is the error over the largest |ref|. The extra
    launch is not counted."""
    from repro_torch.kernels.segment_sum import (ops, segment_sum,
                                                 segment_sum_ref)
    if len(calls) != 1:
        fail(f"{what}: the step made {len(calls)} 2-D segment sums, the "
             "design implies one (the embedding's backward)")
    g, ids, V, out = calls[0]
    other = torch.float32 if g.dtype == torch.bfloat16 else torch.bfloat16
    ids64 = ids.long()
    n = ids64.bincount(minlength=V).float()[:, None]
    rec = {"shape": [int(g.shape[0]), V, int(g.shape[1])],
           "dtype": str(g.dtype).replace("torch.", ""),
           "distinct_ids": int(ids64.unique().numel()),
           "top_id_count": int(n.max())}
    launches = ops.segment_sum.two_d.launches
    for gx, got in ((g, out), (g.to(other), segment_sum(g.to(other), ids,
                                                        V))):
        name = str(gx.dtype).replace("torch.", "")
        if not torch.equal(got, _embed_order_sum(torch, gx, ids, V)):
            fail(f"{what} #1 {name}: not bitwise equal to the token-order "
                 "sum")
        ref = segment_sum_ref(gx, ids, V).float()
        bound = 2 * 2.0 ** -24 * n * segment_sum_ref(
            gx.float().abs(), ids, V)
        if gx.dtype == torch.bfloat16:
            bound = bound + ATTN_RTOL_BF16 * ref.abs()
        diff = (got.float() - ref).abs()
        excess = float((diff - bound).max())
        err, top = float(diff.max()), float(ref.abs().max())
        if not excess <= 0:
            fail(f"{what} #1 {name}: |got - one-hot| exceeds the rounding "
                 f"bound by {excess}")
        rec[name] = {"bitwise_vs_token_order": True, "max_abs_err": err,
                     "rel_err": err / max(top, 1e-30), "max_abs_ref": top,
                     "excess_over_bound": excess}
        del ref, bound, diff
    torch.cuda.synchronize()
    ops.segment_sum.two_d.launches = launches
    return rec


def _train_session(torch, sources, steps, ckpt=None, cfg=None,
                   impl="fused"):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.engine import Session, SessionConfig
    cfg = (cfg or CONFIG).replace(segment_sum_impl=impl)
    scfg = SessionConfig(model="gfm-mtl", arch=cfg, steps=steps,
                         batch_per_task=8, lr=1e-3, warmup=2, log_every=1,
                         eval_every=10 ** 9, seed=0, ckpt_path=ckpt,
                         verbose=False)
    return Session.from_config(scfg, sources=sources, device=DEVICE)


def _train_sources():
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    return source_dicts(generate_all(32, max_atoms=64, max_edges=2048,
                                     seed=0))


def train_phase(torch, counters):
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import make_gfm_mtl
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.engine import multitask_grad_fn
    from repro_torch.serve import ServeSession

    sources = _train_sources()
    ckpt = str(ROOT / "build" / "chip_smoke" / "gfm_train")
    sess = _train_session(torch, sources, TRAIN_STEPS, ckpt)
    n_params = sess.n_params()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sess:
        result = sess.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    rows = result.logger.history
    losses = [r["loss"] for r in rows]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train: losses {losses}")
    # one trunk pass a step: 4 layers each way, and one species
    # embedding's backward (#1)
    want = {"egnn_edge": 4 * TRAIN_STEPS, "egnn_edge_bwd": 4 * TRAIN_STEPS,
            "segment_sum": 0, "segment_sum_2d": TRAIN_STEPS}
    if launches != want:
        fail(f"train launch counts {launches}, design implies {want}")
    # steady step time: host clock between the loss reads of steps 1 and
    # the last (every step is logged, so each row ends in a sync)
    step_ms = (rows[-1]["wall"] - rows[1]["wall"]) / (TRAIN_STEPS - 2) * 1e3

    # one step's gradients against the plain path on the same batch
    dev = torch.device(DEVICE)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             GroupBatcher(sources, 8, seed=1).next_batch().items()}
    params = result.params
    grads = {}
    for impl in ("fused", "jnp"):
        model = make_gfm_mtl(CONFIG.replace(segment_sum_impl=impl),
                             len(sources))
        for c in counters.values():
            c.launches = 0
        (loss, metrics, g), calls = _capture_embed(
            lambda: multitask_grad_fn(model, len(sources))(params, batch))
        grads[impl] = (float(loss), interop.leaves(g))
        if impl == "fused":
            embed_grad = _check_embed(torch, calls, "train")
        elif calls or any(c.launches for c in counters.values()):
            # the plain path sums with the one-hot product throughout
            fail(f"train: the plain path launched kernels "
                 f"{ {k: c.launches for k, c in counters.items()} }")
    torch.cuda.synchronize()
    worst_leaf, worst = None, 0.0
    for k, ref in grads["jnp"][1].items():
        got = grads["fused"][1][k]
        scale = float(ref.abs().max())
        rel = float((got - ref).abs().max()) / max(scale, 1e-30)
        if not rel <= GRAD_TOL:
            fail(f"train grad {k}: relative error {rel} > {GRAD_TOL}")
        if rel >= worst:
            worst_leaf, worst = k, rel
    loss_rel = abs(grads["fused"][0] - grads["jnp"][0]) / abs(grads["jnp"][0])
    if not loss_rel <= GRAD_TOL:
        fail(f"train loss fused vs plain: relative error {loss_rel}")

    # bitwise replay: two 3-step runs from one seed under every
    # aggregation impl (each sums in a fixed order on the card: #3/#4 for
    # "fused", #2 for "scatter" and "pallas" and every node gather's
    # backward, the one-hot product for "jnp")
    replay = {}
    for impl in TRAIN_REPLAY_IMPLS:
        ends = []
        for c in counters.values():
            c.launches = 0
        for _ in range(2):
            with _train_session(torch, sources, 3, impl=impl) as s:
                ends.append(interop.leaves(s.run().params))
        # lint: allow(TRC003): each impl's comparison reads back anyway
        torch.cuda.synchronize()
        same = all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])
        replay[impl] = {"bitwise": same, "launches": {
            k: c.launches for k, c in counters.items()}}
        if not same:
            fail(f"train: two 3-step runs from one seed under impl "
                 f"'{impl}' end with different parameters")
        del ends

    # serve from the written checkpoint
    cfg = CONFIG.replace(segment_sum_impl="fused")
    samples = [({k: s[k][i] for k in ("species", "pos", "edge_src",
                                      "edge_dst", "node_mask", "edge_mask")},
                t) for t, s in enumerate(sources) for i in range(2)]
    with ServeSession.from_checkpoint(ckpt, cfg, max_batch=8,
                                      device=DEVICE) as srv:
        futs = [srv.submit(x, head=t) for x, t in samples]
        served = [f.result(timeout=600) for f in futs]
    if not all(math.isfinite(r["energy"]) and
               bool(torch.isfinite(torch.from_numpy(r["forces"])).all())
               for r in served):
        fail("serving from the trained checkpoint gave non-finite results")
    return {"phase": "train", "config": "hydragnn-gfm",
            "impl": "fused", "steps": TRAIN_STEPS, "tasks": len(sources),
            "batch_per_task": 8, "graphs_per_step": 8 * len(sources),
            "params": n_params, "losses": losses, "launches": launches,
            "wall_s": wall, "step_ms": step_ms, "peak_mem_bytes": peak,
            "grad_vs_plain": {"worst_leaf": worst_leaf, "rel_err": worst,
                              "loss_rel_err": loss_rel,
                              "tolerance": GRAD_TOL},
            "embed_grad": embed_grad,
            "replay_bitwise": True, "replay": replay,
            "served_from_ckpt": len(served)}


# ---------------------------------------------------------------------------
# phase dryrun: one rank's program of a sharded plan, counted and run
# ---------------------------------------------------------------------------

DRY_LM = "granite-moe-3b-a800m"     # (b): fsdp=True, 40 experts (EP needs
                                    # 16 | 40: TP over the expert hidden)
DRY_LM_LAYERS = 3                   # (b) of 32 layers: the count fitted
                                    # from 1 and 2, held at 3 on the card
DRY_PEAK_BAND = (0.9, 1.25)         # measured / static peak, each case


def _dry_case(torch, counters, arch, shape, mesh, cfg=None):
    """One dry-run entry counted on fake tensors and run materialised on
    the card, with the launch counts zeroed just before."""
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.launch import dryrun
    _free(torch)
    for c in counters.values():
        c.launches = 0
    keep = {}
    t0 = time.perf_counter()
    e = dryrun.run_one(arch, shape, mesh, device=DEVICE, cfg_override=cfg,
                       materialize_too=True, keep=keep)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    name = f"dryrun {arch} {shape} {mesh}"
    if e["status"] != "ok":
        fail(f"{name}: {e.get('error')}\n{e.get('trace', '')}")
    mem, mat = e["memory"], e["materialized"]
    state = keep["args"][0]
    real = nbytes(state.params) + nbytes(state.opt_state.m) + \
        nbytes(state.opt_state.v)
    static = mem["param_bytes"] + mem["moment_bytes"]
    model = 3 * mem["param_bytes_model"]
    if not real == static == model:
        fail(f"{name}: state bytes {real} on the card, {static} counted, "
             f"{model} by param_bytes_per_device")
    ratio = mat["peak_bytes"] / mem["peak_bytes"]
    if not DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1]:
        fail(f"{name}: peak {mat['peak_bytes']} B is {ratio} x the static "
             f"{mem['peak_bytes']} B, outside {DRY_PEAK_BAND}")
    kinds = {k: v["count"] for k, v in mat["collectives"].items()}
    want = {k: v["count"] for k, v in e["hlo"]["collectives"].items()}
    if kinds != want:
        fail(f"{name}: collectives {kinds} on the card, {want} counted")
    loss = float(keep["out"][1].loss)
    if not math.isfinite(loss):
        fail(f"{name}: loss {loss}")
    del keep, state
    return {"static": {"memory": mem, "flops": e["hlo"]["flops"],
                       "traffic_bytes": e["hlo"]["traffic_bytes"],
                       "collectives": e["hlo"]["collectives"],
                       "traced": e["hlo"]["traced"]},
            "materialized": {k: mat[k] for k in (
                "peak_bytes", "peak_bytes_tracked", "step_s",
                "collectives", "flops_visible")},
            "state_bytes": real, "peak_ratio": ratio, "loss": loss,
            "launches": launches, "wall_s": wall,
            **{k: e[k] for k in ("kind", "mtp_mode", "accum", "accum_run")
               if k in e}}


def _dry_lm_cfg():
    from repro_torch.configs import get
    return get(DRY_LM).replace(n_layers=DRY_LM_LAYERS)


def dryrun_phase(torch, counters):
    """Phase dryrun (see the module docstring): (a) hydragnn-gfm, rank 0
    of the paper mesh in a fake world of 500 ranks, ``"par"``; (b)
    ``DRY_LM`` at ``train_4k``, rank 0 of the 16 x 16 production mesh,
    cut to ``DRY_LM_LAYERS``."""
    out = {"phase": "dryrun", "peak_band": list(DRY_PEAK_BAND),
           "tolerance": {"state_bytes": "exact", "collectives": "kinds "
                         "and counts exact", "peak": "measured / static "
                         "within peak_band"}}
    a = _dry_case(torch, counters, "hydragnn-gfm", "train_4k", "paper")
    want = {"egnn_edge": 4, "egnn_edge_bwd": 4, "segment_sum": 0,
            "segment_sum_2d": 1}
    if a["launches"] != want or a.get("mtp_mode") != "par":
        fail(f"dryrun (a): mode {a.get('mtp_mode')}, launches "
             f"{a['launches']}, the design implies 'par' and {want}")
    out["gfm_paper"] = a
    b = _dry_case(torch, counters, DRY_LM, "train_4k", "pod", _dry_lm_cfg())
    want = {"egnn_edge": 0, "egnn_edge_bwd": 0, "segment_sum": 0,
            "segment_sum_2d": b["accum_run"]}
    if b["launches"] != want:
        fail(f"dryrun (b): launches {b['launches']}, the design implies "
             f"{want} (one embedding backward a microbatch)")
    b["layers"] = DRY_LM_LAYERS
    out["lm_fsdp"] = b
    out["launches"] = {k: a["launches"][k] + b["launches"][k]
                       for k in a["launches"]}
    return out


# ---------------------------------------------------------------------------
# phase 4b: the multi-source pre-training path at full width
# ---------------------------------------------------------------------------

PIPE_STEPS = 10                     # steps of runs (a) and (b)
SOAK_STEPS = 12                     # accepted steps of the soak (d)
# the soak's faults, pinned to runner ticks (repro's soak covers the same
# five kinds): a NaN rollback, a spike rollback, a producer kill, a failed
# checkpoint write (retried) and a preemption. The guard is repro's soak's:
# every trip rolls back (max_consecutive_trips=1), so the stream replays,
# and spike_factor=50 keeps the data's own loss spikes (a step of 33 after
# ~7 in phase train) from tripping a clean batch over and over
SOAK_FAULTS = {5: "nan_grad", 8: "corrupt_batch", 10: "kill_producer",
               11: "ckpt_write_fail", 14: "preempt"}


def _pipe_session(torch, sources=None, steps=PIPE_STEPS, *, model="gfm-mtl",
                  batch=8, batcher=None, **kw):
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.engine import Session, SessionConfig
    scfg = SessionConfig(model=model, arch=CONFIG.replace(
        segment_sum_impl="fused"), steps=steps, batch_per_task=batch,
        lr=1e-3, warmup=2, log_every=1, eval_every=10 ** 9, seed=0,
        verbose=False, **kw)
    return Session.from_config(scfg, sources=sources, batcher=batcher,
                               device=DEVICE)


def _counted_run(torch, sess, counters):
    """Run a session with every launch count zeroed just before it; returns
    (result, launches, wall seconds)."""
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sess:
        result = sess.run()
    torch.cuda.synchronize()
    return result, {k: c.launches for k, c in counters.items()}, \
        time.perf_counter() - t0


def _check_run(name, result, launches, steps, per_step):
    losses = [r["loss"] for r in result.logger.history]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"train_pipeline {name}: losses {losses}")
    want = {"egnn_edge": per_step * steps, "egnn_edge_bwd": per_step * steps,
            "segment_sum": 0, "segment_sum_2d": steps}
    if launches != want:
        fail(f"train_pipeline {name}: launch counts {launches}, the design "
             f"implies {want}")
    return losses


def _replays(torch, make, name):
    """Two 3-step runs from one seed must end with bitwise equal params."""
    from repro_torch import interop
    ends = []
    for _ in range(2):
        with make() as s:
            ends.append(interop.leaves(s.run().params))
    torch.cuda.synchronize()
    if not all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0]):
        fail(f"train_pipeline {name}: two 3-step runs from one seed end "
             "with different parameters")
    return True


def _state_equal(torch, a, b) -> bool:
    """Params, both moments and both step counters, bit for bit."""
    from repro_torch import interop
    if (a.step, a.opt_state.step) != (b.step, b.opt_state.step):
        return False
    return all(torch.equal(interop.leaves(x)[k], v)
               for x, y in ((a.params, b.params),
                            (a.opt_state.m, b.opt_state.m),
                            (a.opt_state.v, b.opt_state.v))
               for k, v in interop.leaves(y).items())


def _on_card(torch, batch):
    import numpy as np
    dev = torch.device(DEVICE)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def _grads_vs_plain(torch, params, batch, n_tasks, task_weights, cfg=None,
                    tol=GRAD_TOL, what="train_pipeline", floor=1e-30,
                    norm_tol=None):
    """One step's gradients, fused kernels against the plain path
    (``"jnp"``, autograd), per leaf relative to max(``floor``, its largest
    entry) within ``tol``, and with ``norm_tol`` also each leaf's
    |fused - plain| / |plain| (2-norms) within it; ``rel_to_max`` is the
    largest error over the leaf's largest entry, ``norm_rel_err`` the
    largest norm ratio; ``embed_grad`` holds #1 on the fused step's own
    species-embedding cotangent (``_check_embed``)."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import make_gfm_mtl
    from repro_torch.engine import multitask_grad_fn
    grads = {}
    for impl in ("fused", "jnp"):
        model = make_gfm_mtl((cfg or CONFIG).replace(segment_sum_impl=impl),
                             n_tasks)
        (loss, _, g), calls = _capture_embed(
            lambda: multitask_grad_fn(model, n_tasks, task_weights)(
                params, batch))
        grads[impl] = (float(loss), interop.leaves(g))
        if impl == "fused":
            embed_grad = _check_embed(torch, calls, what)
        elif calls:
            fail(f"{what}: the plain path launched #1")
    worst_leaf, worst, to_max = None, 0.0, 0.0
    norm_leaf, norm_worst = None, 0.0
    for k, ref in grads["jnp"][1].items():
        got = grads["fused"][1][k]
        err, top = float((got - ref).abs().max()), float(ref.abs().max())
        rel = err / max(top, floor)
        if not rel <= tol:
            fail(f"{what} grad {k}: error {rel} > {tol} x max({floor}, "
                 f"max |ref|)")
        if rel >= worst:
            worst_leaf, worst = k, rel
        to_max = max(to_max, err / max(top, 1e-30))
        nrel = float((got.double() - ref.double()).norm()
                     / ref.double().norm().clamp_min(1e-300))
        if norm_tol is not None and not nrel <= norm_tol:
            fail(f"{what} grad {k}: |fused - plain| / |plain| {nrel} > "
                 f"{norm_tol}")
        if nrel >= norm_worst:
            norm_leaf, norm_worst = k, nrel
    loss_rel = abs(grads["fused"][0] - grads["jnp"][0]) / abs(grads["jnp"][0])
    if not loss_rel <= tol:
        fail(f"{what} loss fused vs plain: relative error {loss_rel}")
    return {"worst_leaf": worst_leaf, "rel_err": worst, "rel_to_max": to_max,
            "norm_worst_leaf": norm_leaf, "norm_rel_err": norm_worst,
            "loss_rel_err": loss_rel, "loss": grads["fused"][0],
            "tolerance": tol, "scale_floor": floor, "norm_tol": norm_tol,
            "embed_grad": embed_grad}


def _step_times(torch, step_fn, state, batch, iters=5):
    """One training step on a placed batch: device time (``device_ms``) and
    host-clock ms a step with the loss read back each step, as the
    session's logging does."""
    dev = device_ms(torch, lambda: step_fn(state, batch), iters=iters,
                    warm=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        float(step_fn(state, batch)[1].loss)
    host = (time.perf_counter() - t0) / iters * 1e3
    return {"device_ms": dev, "host_ms": host,
            "shape": list(batch["edge_src"].shape)}


def _edge_kernels_at(torch, g, dev, B, A, E, H=866):
    """#3 and #4 through the autograd Function at a bucket shape against
    their plain versions: the forward per output and scratch (out, Pi, Pj,
    S, deg), the backward per gradient (pos needing none, as in training),
    bits over two calls of each; device time of each call."""
    from repro_torch.kernels.egnn_edge import (egnn_edge_agg,
                                               egnn_edge_agg_ref, gemm_plan)
    from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
    h, pos, src, dst, em, phi = _edge_fwd_inputs(torch, g, dev, B, A, E, H)
    got = egnn_edge_agg(h, pos, src, dst, em, phi)
    if not torch.equal(got, egnn_edge_agg(h, pos, src, dst, em, phi)):
        fail(f"egnn_edge at bucket {(B, A, E)}: two calls differ bitwise")
    err, scale = scaled_err(torch, got, egnn_edge_agg_ref(h, pos, src, dst,
                                                          em, phi))
    if not err <= EDGE_TOL * scale:
        fail(f"egnn_edge at bucket {(B, A, E)}: max_abs_err {err} > "
             f"{EDGE_TOL}*{scale}")
    call = _edge_fwd_call(torch, h, pos, src, dst, em, phi)
    fwd_errs = _fwd_rel_errs(torch, call(), _edge_fwd_plain(
        torch, h, pos, src, dst, em, phi))
    for n, e in fwd_errs.items():
        if not e <= EDGE_TOL:
            fail(f"egnn_edge at bucket {(B, A, E)} {n}: relative error {e}")
    fwd_ms = device_ms(torch, call)

    leaves, edges, gup = _edge_bwd_inputs(torch, g, dev, B, A, E, H)
    h, pos, w0, b0, w1, b1 = leaves
    src, dst, em = edges
    agg = egnn_edge_agg(h, pos.detach(), src, dst, em,
                        {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}})
    wrt = [h, w0, b0, w1, b1]
    bwd = [torch.autograd.grad(agg, wrt, gup, retain_graph=True)
           for _ in range(2)]
    if not all(torch.equal(a, b) for a, b in zip(*bwd)):
        fail(f"egnn_edge_bwd at bucket {(B, A, E)}: two calls differ")
    d = [x.detach() for x in leaves]
    sr, dr = torch.where(em, src, A), torch.where(em, dst, A)
    dh, _, dw0i, dw0j, dw0d, db0, dw1, db1 = egnn_edge_bwd_ref(
        gup, d[0], d[1], sr, dr, d[2][:H], d[2][H:2 * H], d[2][2 * H:],
        d[3][None], d[4])
    want = [dh, torch.cat([dw0i, dw0j, dw0d]), db0[0], dw1, db1[0]]
    bwd_errs = {}
    for n, a, b in zip(("dh", "dw0", "db0", "dw1", "db1"), bwd[0], want):
        e = float((a - b).abs().max()) / float(b.abs().max())
        if not e <= BWD_TOL:
            fail(f"egnn_edge_bwd at bucket {(B, A, E)} {n}: relative error "
                 f"{e} > {BWD_TOL}")
        bwd_errs[n] = e
    bcall, _, _ = _edge_bwd_call(torch, leaves, edges, gup, False)
    torch.cuda.synchronize()
    n_valid = int(em.sum())
    return {"shape": [B, A, E, H], "fwd_rel_err": fwd_errs,
            "bwd_rel_err": bwd_errs, "fwd_ms": fwd_ms,
            "bwd_ms": device_ms(torch, bcall),
            "fwd_bound_ms": _edge_fwd_bound(B, A, E, H, n_valid)["bound_ms"],
            "bwd_bound_ms": _edge_bwd_bounds(B, A, E, H, n_valid,
                                             False)["bound_ms"],
            "fwd_splits": list(gemm_plan.fwd_splits(B * A, H)),
            "w1_splits": gemm_plan.w1_splits(B * A, H),
            "valid_edges": n_valid}


def _pad_fractions(batchers, n):
    """Mean pad fraction (atoms, edges) of the next ``n`` batches of each
    batcher."""
    from repro_torch.data.bucketing import pad_fraction
    out = []
    for b in batchers:
        fr = [pad_fraction(b.next_batch()) for _ in range(n)]
        out.append({k: sum(f[k] for f in fr) / n for k in ("atoms", "edges")})
    return out


def train_pipeline_phase(torch, counters):
    import shutil

    from repro_torch.data.bucketing import BucketingBatcher
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.data.store import (PrefetchingBatcher, ShardedSource,
                                        write_store)
    from repro_torch.resilience import (CheckpointPolicy, FaultSchedule,
                                        GuardConfig, ResilienceConfig)
    sources = _train_sources()
    T = len(sources)
    out = {"phase": "train_pipeline", "config": "hydragnn-gfm",
           "impl": "fused", "tasks": T}

    # (a) MTL-All, mixing as loss weights, bucketed
    sess = _pipe_session(torch, sources, mixing=1.0, bucketing=3)
    spec, task_weights = sess.batcher.spec, sess.task_weights
    res_a, launches_a, wall_a = _counted_run(torch, sess, counters)
    losses_a = _check_run("mtl_all", res_a, launches_a, PIPE_STEPS, 4)
    shapes = sorted(sess.batcher.shapes_seen)
    before, after = _pad_fractions(
        [GroupBatcher(sources, 8, seed=0),
         BucketingBatcher(GroupBatcher(sources, 8, seed=0), spec)],
        PIPE_STEPS)
    # one batch, bucketed and as stored
    cut = _on_card(torch, BucketingBatcher(GroupBatcher(sources, 8, seed=1),
                                           spec).next_batch())
    full = GroupBatcher(sources, 8, seed=1).next_batch()
    grads = _grads_vs_plain(torch, res_a.params, cut, T, task_weights)
    untrimmed = _grads_vs_plain(torch, res_a.params, _on_card(torch, full), T,
                                task_weights)["loss"]
    trim_rel = abs(grads["loss"] - untrimmed) / abs(untrimmed)
    if not trim_rel <= GRAD_TOL:
        fail(f"train_pipeline: the bucketed batch's loss {grads['loss']} vs "
             f"the untrimmed batch's {untrimmed}")
    times = {"bucketed": _step_times(torch, sess.step_fn, res_a.state, cut),
             "unbucketed": _step_times(torch, sess.step_fn, res_a.state,
                                       _on_card(torch, full))}
    out["mtl_all"] = {
        "steps": PIPE_STEPS, "batch_per_task": 8, "mixing": 1.0,
        "task_weights": list(task_weights), "bucketing": 3,
        "spec": [list(spec.atom_buckets), list(spec.edge_buckets)],
        "losses": losses_a, "launches": launches_a, "wall_s": wall_a,
        "shapes_seen": [list(s) for s in shapes],
        "pad_fraction_before": before, "pad_fraction_after": after,
        "grad_vs_plain": grads, "trim_loss_rel_err": trim_rel,
        "step": times,
        "replay_bitwise": _replays(torch, lambda: _pipe_session(
            torch, sources, 3, mixing=1.0, bucketing=3), "mtl_all")}
    g = torch.Generator(device=DEVICE)
    g.manual_seed(1)
    # every bucket shape of the grid up to (32, 128), one after another at
    # B=40, the run's own shapes among them
    small = {(a, e) for a in spec.atom_buckets for e in spec.edge_buckets
             if a <= 32 and e <= 128}
    out["kernels_at_buckets"] = [
        _edge_kernels_at(torch, g, torch.device(DEVICE), 8 * T, a, e)
        for a, e in sorted(small | set(shapes))]
    del sess, res_a, cut

    # (b) Baseline-All: one branch, 40 graphs a step from the mixture
    sess = _pipe_session(torch, sources, model="gfm-baseline", batch=8 * T,
                         mixing=1.0, bucketing=3)
    res_b, launches_b, wall_b = _counted_run(torch, sess, counters)
    out["baseline_all"] = {
        "steps": PIPE_STEPS, "batch": 8 * T, "mixing": 1.0,
        "losses": _check_run("baseline_all", res_b, launches_b, PIPE_STEPS,
                             4),
        "launches": launches_b, "wall_s": wall_b,
        "shapes_seen": sorted(list(s) for s in sess.batcher.shapes_seen),
        "replay_bitwise": _replays(torch, lambda: _pipe_session(
            torch, sources, 3, model="gfm-baseline", batch=8 * T,
            mixing=1.0, bucketing=3), "baseline_all")}
    del sess, res_b

    # (c) the sharded store under build/ (which .gitignore covers)
    store = ROOT / "build" / "chip_smoke" / "store"
    shutil.rmtree(store, ignore_errors=True)
    for i, s in enumerate(sources):
        write_store(str(store / f"s{i}"), s, shard_size=8)
    readers = [ShardedSource(str(store / f"s{i}")) for i in range(T)]
    ref = GroupBatcher(sources, 8, seed=0)
    with PrefetchingBatcher(readers, 8, seed=0, depth=2,
                            device=DEVICE) as pb:
        for i in range(12):
            got, want = pb.next_batch(), _on_card(torch, ref.next_batch())
            if sorted(got) != sorted(want) or not all(
                    got[k].device == want[k].device
                    and torch.equal(got[k], want[k])
                    for k in want):
                fail(f"train_pipeline store: batch {i} differs from the "
                     "in-memory GroupBatcher's")
    with _pipe_session(torch, sources, 3, bucketing=3) as mem:
        want = mem.run().state
    with PrefetchingBatcher([ShardedSource(str(store / f"s{i}"))
                             for i in range(T)], 8, seed=0, depth=2,
                            device=DEVICE) as pb, \
            _pipe_session(torch, steps=3, batcher=pb, bucketing=3) as st:
        got = st.run().state
    if not _state_equal(torch, got, want):
        fail("train_pipeline store: a session fed by the store ends "
             "differently from the in-memory session")
    out["store"] = {"batches_equal": 12, "session_bitwise": True,
                    "fetches": sum(r.fetches for r in readers)}

    # (d) the soak: every fault class, a preemption, resume(), then bitwise
    # against a clean run of the same steps
    soak = ROOT / "build" / "chip_smoke" / "soak"
    shutil.rmtree(soak, ignore_errors=True)

    def res(faults=None):
        return ResilienceConfig(
            ckpt_dir=str(soak), faults=faults, retry_base_delay=0.0,
            guard=GuardConfig(warmup_steps=2, spike_factor=50.0,
                              max_consecutive_trips=1),
            policy=CheckpointPolicy(every_steps=4, keep_last=2),
            max_ticks=4 * SOAK_STEPS)
    with _pipe_session(torch, sources, SOAK_STEPS, mixing=1.0, bucketing=3,
                       resilience=res(FaultSchedule.from_dict(SOAK_FAULTS))
                       ) as s:
        faulted = s.run()
    rep = faulted.resilience
    with _pipe_session(torch, sources, SOAK_STEPS, mixing=1.0, bucketing=3,
                       resilience=res()) as s:
        resumed_at = s.resume()
        resumed = s.run()
    with _pipe_session(torch, sources, SOAK_STEPS, mixing=1.0,
                       bucketing=3) as s:
        clean = s.run()
    kinds = {e["kind"] for e in rep["events"]}
    if not (faulted.preempted and rep["faults_fired"] == len(SOAK_FAULTS)
            and rep["rollbacks"] >= 2 and rep["io_retries"] >= 1
            and {"rollback", "pipeline_recovery", "preempt_flush"} <= kinds):
        fail(f"train_pipeline soak: the faults did not all take effect: "
             f"{rep}")
    if not _state_equal(torch, resumed.state, clean.state):
        fail("train_pipeline soak: the faulted run does not end bitwise "
             "equal to the clean run")
    out["soak"] = {"steps": SOAK_STEPS, "faults": SOAK_FAULTS,
                   "events": rep["events"], "trips": rep["trips"],
                   "rollbacks": rep["rollbacks"],
                   "pipeline_recoveries": rep["pipeline_recoveries"],
                   "io_retries": rep["io_retries"],
                   "save_ms": rep["save_ms"] + resumed.resilience["save_ms"],
                   "resumed_at": resumed_at,
                   "final_step": resumed.state.step,
                   "bitwise_vs_clean": True}
    shutil.rmtree(soak, ignore_errors=True)
    out["launches"] = {k: launches_a[k] + launches_b[k] for k in launches_a}
    return out


# ---------------------------------------------------------------------------
# phase 4b2: analysis — the recompile and thread sanitizers on the port's
# seams
# ---------------------------------------------------------------------------

ANALYSIS_STEPS = 19                 # (a): steps after the warm one
ANALYSIS_REPLICAS = 2               # (b): replicas behind the router
ANALYSIS_QUARANTINE = 4             # (a): the task quarantined (a rebuild)


def _analysis_counters():
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    return {"egnn_edge": edge_ops.egnn_edge_agg,
            "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
            "segment_sum": ss_ops.segment_sum,
            "segment_sum_2d": ss_ops.segment_sum.two_d}


def _analysis_train(torch, counters):
    """(a) The recompile budget of training: a warm step, then a budget of
    0 over the session's step functions, #3's split plans and the kernel
    libraries for 19 steps; a quarantine's rebuild must count exactly 1
    and break the budget."""
    from repro_torch.analysis import RecompileBudgetError, RecompileSanitizer
    from repro_torch.kernels import _build
    from repro_torch.kernels.egnn_edge import gemm_plan
    sess = _pipe_session(torch, _train_sources(), steps=ANALYSIS_STEPS + 2,
                         bucketing=3)
    scfg = sess.cfg
    _sync(torch, DEVICE)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sess:
        sess.cfg = scfg.replace(steps=1)
        losses = [sess.run().final_loss]                 # the warm step
        san = RecompileSanitizer(budget=0, label="analysis (a)")
        san.track_session(sess)
        probes = {"w1_splits": gemm_plan.w1_splits,
                  "fwd_splits": gemm_plan.fwd_splits, "build": _build}
        for name, obj in probes.items():
            if not san.track(obj, name):
                fail(f"analysis (a): {name} has no cache-size seam")
        sizes = {"session": len(sess.compiled_functions()),
                 **{k: int(f.cache_info().currsize)
                    for k, f in probes.items() if k != "build"},
                 "build": _build.cache_size()}
        sess.cfg = scfg.replace(steps=ANALYSIS_STEPS)
        losses.append(sess.run().final_loss)
        steady = san.report()
        if san.compilations() != 0:
            fail(f"analysis (a): {ANALYSIS_STEPS} steps after the warm one "
                 f"built {steady}, the budget is 0")
        sess.quarantine_tasks([ANALYSIS_QUARANTINE])
        sess.cfg = scfg.replace(steps=1)
        losses.append(sess.run().final_loss)
        rebuilt = san.report()
        try:
            san.check()
        except RecompileBudgetError as e:
            raised = str(e)
        else:
            fail("analysis (a): a rebuilt step did not break the budget")
    _sync(torch, DEVICE)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if rebuilt != dict(steady, session=1):
        fail(f"analysis (a): the quarantine's rebuild counted {rebuilt}, "
             "the design implies the session's 1 alone")
    if not all(map(math.isfinite, losses)):
        fail(f"analysis (a): losses {losses}")
    steps = ANALYSIS_STEPS + 2
    per = scfg.arch.gnn_layers * steps if DEVICE == "cuda" else 0
    want = {"egnn_edge": per, "egnn_edge_bwd": per, "segment_sum": 0,
            "segment_sum_2d": steps if DEVICE == "cuda" else 0}
    if launches != want:
        fail(f"analysis (a): launch counts {launches}, the design implies "
             f"{want}")
    return {"config": "hydragnn-gfm", "impl": "fused", "dtype": "float32",
            "batch": "5 x 8", "bucket_shapes": sorted(
                list(s) for s in sess.batcher.shapes_seen),
            "warm_steps": 1, "steps": ANALYSIS_STEPS,
            "quarantined": ANALYSIS_QUARANTINE, "cache_sizes": sizes,
            "after_steps": steady, "after_rebuild": rebuilt,
            "raised": raised, "launches": launches, "losses": losses,
            "wall_s": wall}


class _CounterView:
    """A counted wrapper's ``launches``, read and written through an
    object ``ThreadSanitizer.guard_attrs`` can instrument (a function's
    attributes cannot be)."""

    def __init__(self, target):
        self.target = target

    @property
    def launches(self):
        return self.target.launches

    @launches.setter
    def launches(self, n):
        self.target.launches = n


@contextlib.contextmanager
def _thread_contracts(tsan):
    """Instrument two lock contracts for ``tsan`` while the block runs:
    every launch count moves under ``_build``'s counter lock (serving
    replicas launch from several threads, and a bare ``+= 1`` loses
    counts), and the serving streams' pool (``serve.engine.STREAMS``)
    touches its table under its lock. Yields the names of what was
    instrumented."""
    from repro_torch.analysis import TrackedLock
    from repro_torch.kernels import _build
    from repro_torch.serve import engine
    count_lock, views = TrackedLock(), {}
    old_lock, old_count = _build._count_lock, _build.count_launch

    def count(wrapper):
        view = views.get(id(wrapper))
        if view is None:
            view = views[id(wrapper)] = tsan.guard_attrs(
                _CounterView(wrapper), ("launches",), count_lock)
        old_count(view)
    pool = engine.STREAMS
    pool_cls, pool_lock, stream_lock = type(pool), pool._lock, TrackedLock()
    _build._count_lock, _build.count_launch = count_lock, count
    pool._lock = stream_lock
    tsan.guard_attrs(pool, ("_streams",), stream_lock)
    try:
        yield ["_build.count_launch: launches under _count_lock",
               "serve.engine.STREAMS: _streams under its lock"]
    finally:
        pool.__class__ = pool_cls
        pool._lock = pool_lock
        _build._count_lock, _build.count_launch = old_lock, old_count


def _analysis_serve(torch, counters):
    """(b) Serving under both sanitizers: a router of 2 replicas warmed
    over its buckets serves 80 mixed-head requests under ``"fused"`` (#3);
    no shape outside the warmed set, 0 thread-contract violations."""
    from repro_torch.analysis import RecompileSanitizer, ThreadSanitizer
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.launch.mesh import make_replica_meshes
    from repro_torch.serve import ReplicaServeSession
    spec, params, samples, heads = serve_inputs(N_REQUESTS)
    tsan = ThreadSanitizer()
    san = RecompileSanitizer(budget=0, label="analysis (b)")
    with _thread_contracts(tsan) as contracts:
        rep = ReplicaServeSession(
            params, CONFIG.replace(segment_sum_impl="fused"), spec=spec,
            max_batch=8, max_wait_ms=20.0,
            meshes=make_replica_meshes(ANALYSIS_REPLICAS,
                                       devices=[DEVICE] * ANALYSIS_REPLICAS))
        with rep:
            for r, srv in enumerate(rep.replicas):
                tsan.wrap_mutual_exclusion(srv.queue, ("get", "drain"),
                                           group=f"replica {r} drain")
                contracts.append(f"replica {r}'s RequestQueue: get/drain "
                                 "by one worker")
            t0 = time.perf_counter()
            warmed = rep.warmup()
            warm_s = time.perf_counter() - t0
            shapes_warm = [set(s._shapes_compiled) for s in rep.replicas]
            for r, fn in enumerate(rep.jit_functions()):
                if not san.track(fn, f"replica {r}"):
                    fail(f"analysis (b): replica {r}'s forward has no "
                         "cache-size seam")
            _sync(torch, DEVICE)
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            res = _served(rep.submit_many(samples, heads))
            wall = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            st = rep.stats()
        # closed: each worker drained its queue under the wrap
    report = san.report()
    shapes = [set(s._shapes_compiled) for s in rep.replicas]
    batches = st["counters"]["batches"]
    for r, s in zip(res, samples):
        n = int(s["node_mask"].sum())
        if not (math.isfinite(r["energy"]) and r["forces"].shape == (n, 3)):
            fail("analysis (b): a non-finite or misshapen result")
    if san.compilations() != 0 or any(s - w for s, w in
                                      zip(shapes, shapes_warm)):
        fail(f"analysis (b): {report} shapes built past the warm-up")
    if tsan.violations:
        fail("analysis (b): thread-contract violations: " +
             "; ".join(map(str, tsan.violations[:5])))
    if not (launches["egnn_edge"] == (4 * batches if DEVICE == "cuda"
                                      else 0)
            and launches["segment_sum"] == 0):
        fail(f"analysis (b): launch counts {launches} vs {batches} batches")
    return {"config": "hydragnn-gfm", "impl": "fused",
            "kernel": "#3 egnn_edge_fused", "replicas": ANALYSIS_REPLICAS,
            "requests": len(res), "batches": batches,
            "warmed_shapes": warmed, "warmup_s": warm_s,
            "compilations": report, "shapes_by_replica": [len(s) for s in
                                                          shapes],
            "contracts": contracts, "violations": len(tsan.violations),
            "launches": launches, "wall_s": wall}


def analysis_phase(torch):
    """Phase analysis (see the module docstring)."""
    counters = _analysis_counters()
    t0 = time.perf_counter()
    a = _analysis_train(torch, counters)
    b = _analysis_serve(torch, counters)
    launches = {k: a["launches"][k] + b["launches"][k] for k in counters}
    return {"phase": "analysis", "a_train": a, "b_serve": b,
            "c_memory": "train_mtp: each rank's params and moments equal "
                        "its group's hbm_bytes from "
                        "launch.memory.hier_group_memory",
            "launches": launches, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4c: multi-task parallelism (the paper's method), ranks on one card
# ---------------------------------------------------------------------------

MTP_STEPS = 3                       # steps of each rank's run
MTP_RTOL, MTP_ATOL = 5e-5, 1e-6     # repro's cross-plan parity tolerance
                                    # (tests/test_parallel_parity.py)
MTP_ITERS = 3                       # steps a rank times
MTP_TIMEOUT_S = 600                 # one job of ranks, spawn to exit
MTP_RUNS = (("hier", 8, True), ("par", 5, False), ("base", 2, False))
MTP_LAYERS = 2                      # of the trunk's 4 EGNN layers (the
                                    # contract's time; full width)


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _mtp_session(arch, sources, device, *, mesh=None, ckpt=None, **kw):
    """MTL-All at ``arch``, task weights (and so the placement's load
    model) from the paper's source sizes."""
    from repro_torch.data.synthetic_atoms import PAPER_REL_SIZES
    from repro_torch.engine import Session, SessionConfig
    scfg = SessionConfig(model="gfm-mtl", arch=arch, steps=MTP_STEPS,
                         batch_per_task=8, lr=1e-3, warmup=2, log_every=1,
                         eval_every=10 ** 9, seed=0, verbose=False,
                         task_weights=tuple(PAPER_REL_SIZES.values()),
                         ckpt_path=ckpt, **kw)
    return Session.from_config(scfg, sources=sources, mesh=mesh,
                               device=device)


def _per_task(result, T):
    return [[r[f"task{t}"] for t in range(T)]
            for r in result.logger.history]


def _rank_device_ms(torch, fn, iters):
    """This rank's device time of one ``fn`` call from one
    ``torch.profiler`` trace (no retry: every rank runs the same steps);
    None when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.device_time_total for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA)
    return total / iters / 1e3 if total else None


def _collective_ms(torch, dist, n, device, group=None, size=2, reps=3):
    """Host-clock ms of one SUM all-reduce of ``n`` floats over ``group``
    (the world by default), mean of ``reps`` after one warm-up."""
    if size < 2:
        return 0.0
    buf = torch.zeros(n, device=device)
    dist.all_reduce(buf, group=group)
    _sync(torch, device)
    dist.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(reps):
        dist.all_reduce(buf, group=group)
    _sync(torch, device)
    return (time.perf_counter() - t0) / reps * 1e3


def _mtp_rank(rank, world, kind, arch, sources, device, ckpt, full):
    """One rank of phase train_mtp: a ``Session`` under ``kind`` ("hier":
    ``placement=world``; "par": a (1, world) mesh; "base": a (world, 1)
    mesh, heads whole) for ``MTP_STEPS`` steps with its launch counts
    zeroed just before, the trunk's hash after every step, and the bytes
    of its params and moments. ``full`` adds the step's time, the
    all-reduces' time, a second run from the seed and the checkpoint the
    run wrote, read back."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import interop
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.launch.memory import (hier_group_memory,
                                           param_bytes_per_device,
                                           plan_placement)
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    from repro_torch.train import checkpoint
    counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
                "segment_sum": ss_ops.segment_sum,
                "segment_sum_2d": ss_ops.segment_sum.two_d}
    T = len(sources)
    mesh = None if kind == "hier" else (
        make_host_mesh(1, world) if kind == "par" else
        make_host_mesh(world, 1))
    kw = {"placement": world} if kind == "hier" else \
        {"mode": "par" if kind == "par" else "base"}

    def session(ckpt_path=None):
        return _mtp_session(arch, sources, device, mesh=mesh,
                            ckpt=ckpt_path, **kw)

    entered = time.monotonic()
    sess = session(ckpt if full else None)
    plan, dev = sess.plan, rank_device()
    hashes, inner = [], sess.step_fn

    def traced(state, batch):
        state, out = inner(state, batch)
        hashes.append(_sha(interop.leaves(state.params["shared"]).values()))
        return state, out
    sess.step_fn = traced
    _sync(torch, dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    with sess:
        res = sess.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}

    # the §4.3 model: this rank's group's params and AdamW moments
    template = sess.model.init(0, device="meta")
    p_s = sum(x.numel() for x in interop.leaves(template["shared"]).values())
    p_h = sum(x.numel() for x in
              interop.leaves(template["heads"]).values()) // T
    groups = hier_group_memory(plan_placement(plan),
                               param_bytes_per_device(template["shared"]),
                               param_bytes_per_device(template["heads"]) // T)
    want = next(g["hbm_bytes"] for g in groups
                if tuple(g["heads"]) == plan.shard.heads)
    k = len(plan.shard.heads)
    held = sum(param_bytes_per_device(tree) for tree in
               (res.state.params, res.state.opt_state.m,
                res.state.opt_state.v))
    out = {"rank": rank, "heads": list(plan.shard.heads),
           "group": list(plan.shard.ranks),
           "losses": [r["loss"] for r in res.logger.history],
           "per_task": _per_task(res, T), "trunk_sha": hashes,
           "launches": launches, "wall_s": wall, "p_shared": p_s,
           "p_head": p_h, "state_bytes": held, "state_bytes_model": want}
    if plan.placement is not None:
        out["device_counts"] = list(plan.placement.device_counts)
        out["groups"] = [list(g) for g in plan.placement.groups]
    if dev.type == "cuda":
        out["memory_allocated"] = torch.cuda.memory_allocated(dev)
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["t_enter"] = entered
    out["t_import"] = _IMPORTED
    if not full:
        out["t_exit"] = time.monotonic()
        return out

    batch = plan.shard_batch(GroupBatcher(sources, 8, seed=1).next_batch())
    state = res.state
    dist.barrier()
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(MTP_ITERS):
        float(inner(state, batch)[1].loss)
    out["step_host_ms"] = (time.perf_counter() - t0) / MTP_ITERS * 1e3
    out["step_device_ms"] = _rank_device_ms(
        torch, lambda: inner(state, batch), MTP_ITERS) \
        if dev.type == "cuda" else None
    out["batch_shape"] = list(batch["edge_src"].shape)
    out["allreduce_trunk_ms"] = _collective_ms(torch, dist, p_s, dev,
                                               size=world)
    out["allreduce_heads_ms"] = _collective_ms(
        torch, dist, p_h * k, dev, group=plan.head_group,
        size=plan.shard.size)

    again = session()
    with again:
        res2 = again.run()
    a, b = interop.leaves(res.params), interop.leaves(res2.params)
    out["replay_bitwise"] = all(torch.equal(a[n], b[n]) for n in a)
    back = interop.leaves(checkpoint.restore_sharded(
        ckpt, {"params": res.params}, plan)["params"])
    out["restore_own_rows"] = all(
        np.array_equal(back[n], a[n].cpu().numpy()) for n in a)
    whole = interop.leaves(plan.gather_params(res.params))
    if rank == 0:
        out["full_sha"] = _sha(v for _, v in sorted(whole.items()))
    out["t_exit"] = time.monotonic()
    return out


def _close_rows(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|); fails above 1."""
    worst = 0.0
    for g_row, w_row in zip(got, want, strict=True):
        for g, w in zip(g_row, w_row, strict=True):
            worst = max(worst, abs(g - w) / (MTP_ATOL + MTP_RTOL * abs(w)))
    return worst


def train_mtp_phase(torch, device=DEVICE, arch=None):
    """Phase train_mtp (see the module docstring)."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.train import checkpoint
    arch = arch or CONFIG.replace(segment_sum_impl="fused",
                                  gnn_layers=MTP_LAYERS)
    sources = _train_sources()
    T = len(sources)
    ref_sess = _mtp_session(arch, sources, device)
    with ref_sess:
        ref = ref_sess.run()
    ref_rows = _per_task(ref, T)
    ref_losses = [r["loss"] for r in ref.logger.history]
    if device == "cuda":
        torch.cuda.empty_cache()
    ckpt = str(ROOT / "build" / "chip_smoke" / "mtp_hier")
    out = {"phase": "train_mtp", "config": "hydragnn-gfm",
           "gnn_layers": arch.gnn_layers, "impl": "fused",
           "backend": "gloo", "steps": MTP_STEPS, "batch_per_task": 8,
           "tolerance": {"rtol": MTP_RTOL, "atol": MTP_ATOL},
           "note": "ranks time-share one card over gloo: times are not a "
                   "scaling result, and NCCL is not exercised",
           "reference": {"losses": ref_losses, "per_task": ref_rows}}
    launches = {"egnn_edge": 0, "egnn_edge_bwd": 0, "segment_sum": 0,
                "segment_sum_2d": 0}
    # one trunk pass a step, one launch a layer each way and one species
    # embedding's backward (none off the card: the CPU rehearsal runs the
    # plain versions)
    per = arch.gnn_layers * MTP_STEPS if device == "cuda" else 0
    want = {"egnn_edge": per, "egnn_edge_bwd": per, "segment_sum": 0,
            "segment_sum_2d": MTP_STEPS if device == "cuda" else 0}
    rdzv = ROOT / "build" / "chip_smoke"
    rdzv.mkdir(parents=True, exist_ok=True)
    for kind, world, full in MTP_RUNS:
        t0, spawned = time.perf_counter(), time.monotonic()
        try:
            ranks = run_ranks(_mtp_rank, world, backend="gloo", device=device,
                              args=(kind, arch, sources, device, ckpt, full),
                              timeout=MTP_TIMEOUT_S, rdzv_dir=str(rdzv))
        except Exception as e:                        # noqa: BLE001
            fail(f"train_mtp {kind}: {e}")
        wall, back = time.perf_counter() - t0, time.monotonic()
        name = f"train_mtp {kind}"
        worst = max(_close_rows(r["per_task"], ref_rows) for r in ranks)
        if not worst <= 1.0:
            fail(f"{name}: per-task losses off the single-process "
                 f"session's by {worst} x the tolerance")
        worst_total = max(_close_rows([r["losses"]], [ref_losses])
                          for r in ranks)
        if not worst_total <= 1.0:
            fail(f"{name}: total losses off by {worst_total} x tolerance")
        for i in range(MTP_STEPS):
            if len({r["trunk_sha"][i] for r in ranks}) != 1:
                fail(f"{name}: trunk params differ across ranks after step "
                     f"{i}")
        for r in ranks:
            if r["launches"] != want:
                fail(f"{name} rank {r['rank']}: launch counts "
                     f"{r['launches']}, the design implies {want}")
            if r["state_bytes"] != r["state_bytes_model"]:
                fail(f"{name} rank {r['rank']}: {r['state_bytes']} bytes of "
                     f"params and moments, its group's hbm_bytes "
                     f"(hier_group_memory) {r['state_bytes_model']}")
            for k_ in launches:
                launches[k_] += r["launches"][k_]
        heads = [r["heads"] for r in ranks]
        if kind == "hier" and ranks[0]["device_counts"] != [2, 1, 3, 1, 1]:
            fail(f"{name}: groups {ranks[0]['device_counts']}, the solver "
                 "gives (2, 1, 3, 1, 1) for the paper's sizes on 8")
        if kind == "par" and heads != [[t] for t in range(T)]:
            fail(f"{name}: heads by rank {heads}, one each expected")
        if kind == "base" and heads != [list(range(T))] * world:
            fail(f"{name}: heads by rank {heads}, all on each expected")
        keep = ("rank", "heads", "group", "state_bytes", "state_bytes_model",
                "memory_allocated", "max_memory_allocated", "wall_s",
                "step_host_ms", "step_device_ms", "batch_shape",
                "allreduce_trunk_ms", "allreduce_heads_ms")
        # where a job's wall time goes: spawn to the last rank's entry
        # (interpreters, torch, CUDA contexts, gloo), the ranks' work, and
        # the last rank's exit to the results (teardown)
        row = {"world": world, "wall_s": wall,
               "startup_s": max(r["t_enter"] for r in ranks) - spawned,
               "import_s": max(r["t_import"] for r in ranks) - spawned,
               "ranks_s": max(r["t_exit"] for r in ranks)
               - max(r["t_enter"] for r in ranks),
               "teardown_s": back - max(r["t_exit"] for r in ranks),
               "per_task_err_vs_tol": worst,
               "loss_err_vs_tol": worst_total,
               "per_task": ranks[0]["per_task"], "losses": ranks[0]["losses"],
               "launches_per_rank": want,
               "p_shared": ranks[0]["p_shared"],
               "p_head": ranks[0]["p_head"],
               "ranks": [{k_: r[k_] for k_ in keep if k_ in r}
                         for r in ranks]}
        if kind == "hier":
            row["device_counts"] = ranks[0]["device_counts"]
        if full:
            if not all(r["replay_bitwise"] for r in ranks):
                fail(f"{name}: two runs from one seed differ bitwise")
            if not all(r["restore_own_rows"] for r in ranks):
                fail(f"{name}: restore_sharded gave a rank other rows than "
                     "its own")
            back = checkpoint.restore(ckpt, {"params": ref.params})
            one = _mtp_session(arch, sources, device)
            one.state = one.state._replace(
                params=interop.to_torch(back["params"], device))
            sha = _sha(v for _, v in
                       sorted(interop.leaves(one.state.params).items()))
            if sha != ranks[0]["full_sha"]:
                fail(f"{name}: the checkpoint rank 0 wrote does not restore "
                     "bitwise into a one-process session")
            row.update(replay_bitwise=True, ckpt_restored_bitwise=True)
        out[kind] = row
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 4d: the bf16 GNN path at full width
# ---------------------------------------------------------------------------

def check_egnn_edge_bwd_bf16(torch, dev, g):
    """#4 on bf16 g, h and weights, at B=40 without dpos (training) and B=8
    with. Through ``egnn_edge_agg(compute_dtype=bf16)``'s autograd Function
    on a bf16 h leaf and f32 φ_e leaves, as the trunk calls it: one launch
    counted on ``egnn_edge_bwd.bf16``, dh in bf16 and the rest in f32, each
    per output within ``BWD_TOL`` of its largest entry against the plain
    version on the same bf16 values (dh also within the half ulp of its
    rounding to bf16), two calls bitwise. The wrapper's own launch
    (``ops.egnn_edge_bwd``) on those values is bitwise equal to #4's f32
    launch on their f32 copies and gives the autograd cotangents' bits;
    device time of both launches beside the plain version and
    ``torch.matmul`` (fp32) of its six products."""
    from repro_torch.kernels.egnn_edge import egnn_edge_agg, ops
    from repro_torch.kernels.egnn_edge.ref import egnn_edge_bwd_ref
    H, bf16 = 866, torch.bfloat16
    names = ("dh", "dpos", "dw0", "db0", "dw1", "db1")
    worst, out = 0.0, {}
    for name, B, A, E, need_dpos in (("train", 40, 64, 2048, False),
                                     ("b8", 8, 64, 2048, True)):
        leaves, (src, dst, em), gup = _edge_bwd_inputs(torch, g, dev, B, A, E,
                                                       H)
        h = leaves[0].detach().bfloat16().requires_grad_(True)
        pos, w0, b0, w1, b1 = leaves[1:]
        phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
        wrt = [h, pos, w0, b0, w1, b1] if need_dpos else [h, w0, b0, w1, b1]
        agg = egnn_edge_agg(h, pos if need_dpos else pos.detach(), src, dst,
                            em, phi, compute_dtype=bf16)
        gb = gup.bfloat16()

        def bwd():
            return torch.autograd.grad(agg, wrt, gb, retain_graph=True)
        before = (ops.egnn_edge_bwd.launches, ops.egnn_edge_bwd.bf16.launches)
        got, again = bwd(), bwd()
        if (ops.egnn_edge_bwd.launches,
                ops.egnn_edge_bwd.bf16.launches) != (before[0], before[1] + 2):
            fail(f"egnn_edge_bwd_bf16 {name}: a bf16 call launched another "
                 f"kernel than the bf16 backward")
        # lint: allow(TRC003): each case's check reads back anyway
        torch.cuda.synchronize()
        if agg.dtype != bf16 or [x.dtype for x in got] != \
                [x.dtype for x in wrt]:
            fail(f"egnn_edge_bwd_bf16 {name}: out in {agg.dtype}, "
                 f"cotangents in {[x.dtype for x in got]}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"egnn_edge_bwd_bf16 {name}: two calls differ bitwise")
        if not need_dpos:
            got = got[:1] + (None,) + got[1:]
        # the plain version and the wrapper's own launch on the values the
        # autograd Function passes: bf16 g, h and weights, the forward's
        # f32 scratch
        hd, w0b, b0b, w1b, b1b = (x.detach().bfloat16()
                                  for x in (h, w0, b0, w1, b1))
        pos = pos.detach()
        sr = torch.where(em, src, A).to(torch.int32).contiguous()
        dr = torch.where(em, dst, A).to(torch.int32).contiguous()
        _, pi, pj, s, deg = ops._launch_fwd(
            hd, pos, sr, dr, w0b, b0b, w1b, b1b, bf16,
            *ops._resolve_blocks(None, None, A, E, H))

        def plain():
            return egnn_edge_bwd_ref(gb, hd, pos, sr, dr, w0b[:H],
                                     w0b[H:2 * H], w0b[2 * H:], b0b[None],
                                     w1b)
        dh, dpos, dw0i, dw0j, dw0d, db0, dw1, db1 = plain()
        errs = {}
        for n, a, b in zip(names, got, (dh, dpos, torch.cat(
                [dw0i, dw0j, dw0d]), db0[0], dw1, db1[0])):
            if a is None:
                continue
            b = b.float()
            diff = (a.float() - b).abs()
            scale = float(b.abs().max())
            lim = BWD_TOL * scale
            # dh comes back in its primal's dtype: its rounding to bf16
            # moves it by at most 2^-8 of itself
            over = diff > (lim * (1 + 2.0 ** -8) + 2.0 ** -8 * b.abs()
                           if n == "dh" else lim)
            if bool(over.any()):
                fail(f"egnn_edge_bwd_bf16 {name} {n}: max_abs_err "
                     f"{float(diff.max())} > {BWD_TOL}*{scale}"
                     + (" + its bf16 rounding" if n == "dh" else ""))
            errs[n] = float(diff.max()) / scale
            worst = max(worst, float(diff.max()))
        del dh, dpos, dw0i, dw0j
        kw = {"need_dpos": need_dpos, **dict(zip(
            ("block_e", "block_h"),
            ops._resolve_blocks(None, None, A, E, H, bwd=True)))}

        def call():
            return ops.egnn_edge_bwd(gb, hd, pos, sr, dr, w0b, w1b, pi, pj, s,
                                     deg, **kw)
        up = [x.float() for x in (gb, hd, w0b, w1b)]

        def call32():
            return ops.egnn_edge_bwd(up[0], up[1], pos, sr, dr, up[2], up[3],
                                     pi, pj, s, deg, **kw)
        direct, want = call(), call32()
        # lint: allow(TRC003): each case's check reads back anyway
        torch.cuda.synchronize()
        bitwise = {n: a is None or torch.equal(a, b)
                   for n, a, b in zip(names, direct, want)}
        if not all(bitwise.values()):
            diff = {n: float((a - b).abs().max()) for n, a, b in
                    zip(names, direct, want) if a is not None}
            fail(f"egnn_edge_bwd_bf16 {name}: not bitwise equal to the f32 "
                 f"launch on the upcast values: {bitwise}, max |diff| "
                 f"{diff}")
        if not all(a is None or torch.equal(a, b.to(a.dtype))
                   for a, b in zip(got, direct)):
            fail(f"egnn_edge_bwd_bf16 {name}: the autograd cotangents are "
                 f"not the wrapper's launch's bits (dh rounded to bf16)")
        prof = device_profile(torch, call)
        most = 4 if need_dpos else 3
        if prof["kernels_per_call"] > most:
            fail(f"egnn_edge_bwd_bf16 {name}: {prof['kernels_per_call']} "
                 f"kernels a call, the design has at most {most}")
        n_valid = int(em.sum())
        case = {"ms": prof["ms"], "by_kernel": prof["by_kernel"],
                "kernels_per_call": prof["kernels_per_call"],
                "wall_ms": time_ms(torch, call),
                "f32_ms": device_ms(torch, call32),
                "plain_ms": time_ms(torch, plain, iters=3, warm=1),
                "library_ms": None,
                "library_note": "no one PyTorch call computes this backward",
                "gemm_library_ms": device_ms(
                    torch, _gemm_library(torch, B, A, H, g, dev)),
                "gemm_library_bf16_ms": device_ms(
                    torch, _gemm_library(torch, B, A, H, g, dev,
                                         torch.bfloat16)),
                "shape": [B, A, E, H], "dpos": need_dpos,
                "valid_edges": n_valid, "bitwise_vs_f32_upcast": True,
                "rel_err": errs,
                **_edge_bwd_bounds(B, A, E, H, n_valid, need_dpos,
                                   bf16=True)}
        if name == "train":
            out.update(case)
        else:
            out[name] = case
        del agg, got, again, direct, want
    out["max_abs_err"] = worst
    return out


def gnn_bf16_phase(torch, serve_rows, counters):
    """Phase gnn_bf16 (the module docstring): hydragnn-gfm at full width in
    bf16 compute, (b) served under ``"fused"`` and ``"pallas"``, (c)
    trained under ``"fused"``; the kernel checks (a) are
    ``check_egnn_edge(cd=bf16)`` and ``check_egnn_edge_bwd_bf16``.
    ``counters`` are zeroed just before each pass and run."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.data.loader import GroupBatcher
    from repro_torch.serve import ServeSession
    cfg = CONFIG.replace(compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()

    # (b) serving
    spec, params, samples, heads = serve_inputs(N_REQUESTS)
    res, info = {}, {}
    for impl in ("fused", "pallas"):
        res[impl], info[impl] = serve_pass(torch, impl, params, spec, samples,
                                           heads, counters, cfg=cfg)
    lf, lp = info["fused"]["launches"], info["pallas"]["launches"]
    if not (lf["egnn_edge_bf16"] == 4 * info["fused"]["batches"] > 0
            and lf["egnn_edge"] == lf["segment_sum"] == 0):
        fail(f"gnn_bf16 fused serve launch counts {lf} vs "
             f"{info['fused']['batches']} batches")
    if not (lp["segment_sum"] == 4 * info["pallas"]["batches"] > 0
            and lp["egnn_edge"] == lp["egnn_edge_bf16"] == 0):
        fail(f"gnn_bf16 pallas serve launch counts {lp} vs "
             f"{info['pallas']['batches']} batches")
    idx = list(range(0, N_REQUESTS, max(1, N_REQUESTS // 8)))
    with ServeSession(params, cfg.replace(segment_sum_impl="jnp"), spec=spec,
                      max_batch=8, device=DEVICE) as plain:
        res_plain = [plain.predict_one(samples[i], head=heads[i])
                     for i in idx]
    vs_plain = {impl: serve_rel_err([res[impl][i] for i in idx], res_plain)
                for impl in res}
    for impl, e in vs_plain.items():
        if not e <= EDGE_BF16_TOL:
            fail(f"gnn_bf16 {impl} serve rows differ from the plain bf16 "
                 f"forward: {e} > {EDGE_BF16_TOL}")
    serve = {"fused": info["fused"], "pallas": info["pallas"],
             "vs_plain_rel_err": vs_plain,
             "fused_vs_pallas_rel_err": serve_rel_err(res["fused"],
                                                      res["pallas"]),
             "vs_f32_serve_rel_err": serve_rel_err(res["fused"], serve_rows),
             "rows_bitwise_vs_predict_one": True}
    torch.cuda.empty_cache()

    # (c) training
    sources = _train_sources()
    ckpt = str(ROOT / "build" / "chip_smoke" / "gfm_train_bf16")
    result, launches, wall = _counted_run(
        torch, _train_session(torch, sources, TRAIN_STEPS, ckpt, cfg=cfg),
        counters)
    losses = [r["loss"] for r in result.logger.history]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"gnn_bf16 train: losses {losses}")
    want = {"egnn_edge": 0, "egnn_edge_bwd": 0, "segment_sum": 0,
            "segment_sum_2d": TRAIN_STEPS,
            "egnn_edge_bf16": 4 * TRAIN_STEPS,
            "egnn_edge_bwd_bf16": 4 * TRAIN_STEPS}
    if launches != want:
        fail(f"gnn_bf16 train launch counts {launches}, design implies "
             f"{want}")
    batch = _on_card(torch, GroupBatcher(sources, 8, seed=1).next_batch())
    grads = _grads_vs_plain(torch, result.params, batch, len(sources), None,
                            cfg=cfg, tol=EDGE_BF16_TOL, what="gnn_bf16",
                            floor=1.0, norm_tol=BF16_GRAD_NORM_TOL)
    ends = []
    for _ in range(2):
        with _train_session(torch, sources, 3, cfg=cfg) as s:
            ends.append(interop.leaves(s.run().params))
    torch.cuda.synchronize()
    if not all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0]):
        fail("gnn_bf16 train: two 3-step runs from one seed end with "
             "different parameters")
    if not all(v.dtype == torch.float32 for v in ends[0].values()):
        fail("gnn_bf16 train: parameters left fp32")
    jobs = [({k: s[k][i] for k in ("species", "pos", "edge_src", "edge_dst",
                                   "node_mask", "edge_mask")}, t)
            for t, s in enumerate(sources) for i in range(2)]
    counters["egnn_edge_bf16"].launches = 0
    with ServeSession.from_checkpoint(ckpt, cfg.replace(
            segment_sum_impl="fused"), max_batch=8, device=DEVICE) as srv:
        served = [f.result(timeout=600) for f in
                  [srv.submit(x, head=t) for x, t in jobs]]
    if not (all(math.isfinite(r["energy"]) and
                bool(torch.isfinite(torch.from_numpy(r["forces"])).all())
                for r in served)
            and counters["egnn_edge_bf16"].launches > 0):
        fail("gnn_bf16: serving the trained checkpoint in bf16 gave "
             "non-finite results or launched no bf16 kernel")
    train = {"steps": TRAIN_STEPS, "graphs_per_step": 8 * len(sources),
             "losses": losses, "launches": launches, "wall_s": wall,
             "grad_vs_plain": grads, "replay_bitwise": True,
             "served_from_ckpt": len(served)}
    return {"phase": "gnn_bf16", "config": "hydragnn-gfm",
            "compute_dtype": "bfloat16", "param_dtype": "float32",
            "tolerance": EDGE_BF16_TOL, "serve": serve, "train": train,
            "wall_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4e: downstream fine-tuning at full width
# ---------------------------------------------------------------------------

FT_STEPS = 5                        # pre-training and each fine-tuning run
FT_LR = 3e-4                        # fine-tuning at full width: the
                                    # example's smoke-width 3e-3 diverged
                                    # here (loss 23 -> 6.7e8 in 5 steps)
FT_SOURCES = ("ani1x", "qm7x", "mptrj")


def _example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zeroed(torch, counters):
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0


def _counts(torch, counters):
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}


def _rel_leaves(torch, got, ref, what, tol=GRAD_TOL):
    """Each leaf of ``got`` within ``tol`` x its largest entry of ``ref``;
    returns (worst leaf, worst error)."""
    from repro_torch import interop
    worst_leaf, worst = None, 0.0
    ref = interop.leaves(ref)
    for k, g in interop.leaves(got).items():
        rel = float((g - ref[k]).abs().max()) / max(
            float(ref[k].abs().max()), 1e-30)
        if not rel <= tol:
            fail(f"{what} {k}: relative error {rel} > {tol}")
        if rel >= worst:
            worst_leaf, worst = k, rel
    return worst_leaf, worst


def finetune_phase(torch, counters):
    """The paper's downstream fine-tuning (``examples/
    finetune_downstream_torch.py``'s functions) at hydragnn-gfm's full
    width: pre-train a ``Session`` 5 steps on 3 sources x 8 graphs, then
    fine-tune a fresh branch and the trunk 5 steps on 12 transition1x
    graphs (a ``SingleTaskModel`` through ``ShardingPlan().compile(
    make_step(...))``), from the pre-trained trunk and from a scratch one,
    and evaluate both on 64 held-out graphs."""
    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core import gfm_eval_fn
    from repro_torch.data.synthetic_atoms import generate_all, source_dicts
    from repro_torch.engine import (Session, SessionConfig, make_grad_fn,
                                    with_grad_accum)
    from repro_torch.models import gnn
    ft = _example("finetune_downstream_torch")
    cfg = CONFIG.replace(segment_sum_impl="fused")
    plain = CONFIG.replace(segment_sum_impl="jnp")
    dev = torch.device(DEVICE)
    per_step = {"egnn_edge": cfg.gnn_layers, "egnn_edge_bwd": cfg.gnn_layers,
                "segment_sum": 0, "segment_sum_2d": 1}

    def want(steps, micro=1):
        return {k: v * steps * micro for k, v in per_step.items()}

    data = source_dicts(generate_all(16, max_atoms=CONFIG.max_atoms,
                                     max_edges=CONFIG.max_edges,
                                     sources=list(FT_SOURCES)))
    scfg = SessionConfig(model="gfm-mtl", arch=cfg, steps=FT_STEPS,
                         batch_per_task=8, lr=1e-3, warmup=2, log_every=1,
                         eval_every=10 ** 9, seed=0, verbose=False)
    pre, pre_launches, pre_wall = _counted_run(
        torch, Session.from_config(scfg, sources=data,
                                   task_names=list(FT_SOURCES),
                                   device=DEVICE), counters)
    pre_losses = [r["loss"] for r in pre.logger.history]
    if len(pre_losses) != FT_STEPS or not all(map(math.isfinite,
                                                  pre_losses)):
        fail(f"finetune pre-training: losses {pre_losses}")
    if pre_launches != want(FT_STEPS):
        fail(f"finetune pre-training: launches {pre_launches}, the design "
             f"implies {want(FT_STEPS)}")
    ds_train, ds_test = ft.downstream(cfg, dev)
    trunks = {"pretrained": pre.params["shared"],
              "scratch": gnn.egnn_init(cfg, seed=7, device=dev)}
    ev, ev_plain = gfm_eval_fn(cfg), gfm_eval_fn(plain)
    runs, ends = {}, {}
    for name, shared in trunks.items():
        _zeroed(torch, counters)
        t0 = time.perf_counter()
        state, losses = ft.finetune(cfg, shared, ds_train, FT_STEPS,
                                    lr=FT_LR, device=dev)
        launches = _counts(torch, counters)
        wall = time.perf_counter() - t0
        losses = [float(x) for x in losses]
        if not all(map(math.isfinite, losses)):
            fail(f"finetune {name}: losses {losses}")
        if launches != want(FT_STEPS):
            fail(f"finetune {name}: launches {launches}, the design implies "
                 f"{want(FT_STEPS)} (one trunk pass a step: 4 layers each "
                 "way, one species embedding's backward)")
        moved = sum(not torch.equal(a, b) for a, b in zip(
            interop.leaves(state.params["shared"]).values(),
            interop.leaves(shared).values()))
        if not moved:
            fail(f"finetune {name}: the trunk's params did not move")
        mae = [float(x) for x in ev(state.params["shared"],
                                    state.params["branch"], ds_test)]
        mae_plain = [float(x) for x in ev_plain(state.params["shared"],
                                                state.params["branch"],
                                                ds_test)]
        mae_err = max(abs(a - b) / abs(b) for a, b in zip(mae, mae_plain))
        if not mae_err <= SERVE_TOL:
            fail(f"finetune {name}: held-out MAEs {mae} through the kernels "
                 f"vs {mae_plain} plain: relative error {mae_err}")
        ends[name] = interop.leaves(state.params)
        runs[name] = {"losses": losses, "launches": launches, "wall_s": wall,
                      "trunk_leaves_moved": moved,
                      "energy_mae": mae[0], "force_mae": mae[1],
                      "plain_energy_mae": mae_plain[0],
                      "plain_force_mae": mae_plain[1],
                      "mae_rel_err_vs_plain": mae_err}
    # replay: the pre-trained run again, bitwise
    state, _ = ft.finetune(cfg, trunks["pretrained"], ds_train, FT_STEPS,
                           lr=FT_LR, device=dev)
    again = interop.leaves(state.params)
    if not all(torch.equal(again[k], v)
               for k, v in ends["pretrained"].items()):
        fail("finetune: two runs from one seed end with different params")
    del state, again

    # one fine-tuning step's gradients, kernels against the plain path
    model = ft.finetune_model(cfg, trunks["pretrained"])
    p0 = model.init(None, dev)
    (loss, _, grads), calls = _capture_embed(
        lambda: make_grad_fn(model)(p0, ds_train))
    embed_grad = _check_embed(torch, calls, "finetune")
    (ploss, _, pgrads), calls = _capture_embed(
        lambda: make_grad_fn(ft.finetune_model(
            plain, trunks["pretrained"]))(p0, ds_train))
    if calls:
        fail("finetune: the plain path launched #1")
    worst_leaf, worst = _rel_leaves(torch, grads, pgrads, "finetune grad")
    loss_rel = abs(float(loss) - float(ploss)) / abs(float(ploss))
    if not loss_rel <= GRAD_TOL:
        fail(f"finetune loss fused vs plain: relative error {loss_rel}")
    # accum=2 on the flat batch: the mean of its two halves' gradients,
    # through the kernels; accum=1 normalises the forces over all 12
    # graphs' atoms, each half over its own, so it is a neighbour, not
    # the same function (recorded, not held)
    grad_fn = make_grad_fn(model)
    _zeroed(torch, counters)
    aloss, _, agrads = with_grad_accum(grad_fn, 2, axis=0)(p0, ds_train)
    acc_launches = _counts(torch, counters)
    if acc_launches != want(1, micro=2):
        fail(f"finetune accum=2: launches {acc_launches}, the design "
             f"implies {want(1, micro=2)}")
    halves = [grad_fn(p0, {k: v[i * 6:(i + 1) * 6]
                           for k, v in ds_train.items()}) for i in range(2)]
    mean = interop.tree_map(lambda a, b: (a + b) / 2, halves[0][2],
                            halves[1][2])
    acc_leaf, acc_err = _rel_leaves(torch, agrads, mean, "finetune accum=2")
    ref = interop.leaves(grads)
    vs_accum1 = max(float((g - ref[k]).abs().max())
                    / max(float(ref[k].abs().max()), 1e-30)
                    for k, g in interop.leaves(agrads).items())
    pt, sc = runs["pretrained"], runs["scratch"]
    return {"phase": "finetune", "config": "hydragnn-gfm", "impl": "fused",
            "pretrain": {"sources": list(FT_SOURCES), "steps": FT_STEPS,
                         "batch_per_task": 8, "losses": pre_losses,
                         "launches": pre_launches, "wall_s": pre_wall},
            "downstream": {"source": "transition1x", "lr": FT_LR,
                           "train_graphs": int(ds_train["species"].shape[0]),
                           "held_out_graphs":
                           int(ds_test["species"].shape[0]),
                           "steps": FT_STEPS},
            "runs": runs,
            "launches": {k: pt["launches"][k] + sc["launches"][k]
                         + acc_launches[k] for k in per_step},
            "replay_bitwise": True,
            "grad_vs_plain": {"worst_leaf": worst_leaf, "rel_err": worst,
                              "loss_rel_err": loss_rel,
                              "tolerance": GRAD_TOL},
            "embed_grad": embed_grad,
            "accum2": {"vs_halves_worst_leaf": acc_leaf,
                       "vs_halves_rel_err": acc_err, "tolerance": GRAD_TOL,
                       "launches": acc_launches,
                       "loss": float(aloss),
                       "vs_accum1_rel_err": vs_accum1},
            "mae_ratio_scratch_over_pretrained": {
                "energy": sc["energy_mae"] / pt["energy_mae"],
                "force": sc["force_mae"] / pt["force_mae"]}}


# ---------------------------------------------------------------------------
# phase 4f: LM training at full width
# ---------------------------------------------------------------------------

LM_TRAIN_STEPS = 5                  # run (a)
LM_MTL_STEPS = 3                    # run (b)
LM_REPLAY_STEPS = 3
LM_B, LM_S = 8, 1024                # (a): 8 x 1024 tokens a step
LM_TASKS, LM_TASK_B = 4, 2          # (b): 4 tasks x 2 x 1024
SS_CARRY_PLAN = (384, 32, 4, 32, 8)  # #1's plan at the embedding's
                                    # shape with a carried window (32-id
                                    # windows, 32 lanes): the one before
                                    # the whole-list window (block_n,
                                    # block_e, vec, lanes, chunks)


def _lm_session(cfg, model, sources, steps, batch):
    from repro_torch.engine import Session, SessionConfig
    scfg = SessionConfig(model=model, arch=cfg, steps=steps,
                         batch_per_task=batch, lr=3e-4, log_every=1,
                         eval_every=10 ** 9, seed=0, verbose=False)
    return Session.from_config(scfg, sources=sources, device=DEVICE)


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


MEMORY = {}                         # phase -> device memory at its start
_START = [time.perf_counter()]      # the script's start (``t_s`` in MEMORY)


def _phase_start(torch, name):
    """Before a phase: collect garbage, free the cuBLAS workspaces earlier
    phases left and return the cached blocks, then reset the peak counter,
    so that each phase's peaks are its own. PyTorch keeps one 32 MiB
    cuBLAS workspace for each (cuBLAS handle, stream) pair that ran a GEMM
    until it is told to free them: serve_scaleout's replicas and entries,
    each on a stream and a thread of its own, left 48 (1.6 GB) alive, which
    Python cannot see. Records the bytes allocated before and after."""
    _free(torch)
    before = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    MEMORY[name] = {"t_s": time.perf_counter() - _START[0],
                    "allocated_bytes": before,
                    "after_cublas_workspaces_freed":
                    torch.cuda.memory_allocated()}
    print(f"chip_smoke: phase {name}: {json.dumps(MEMORY[name])}",
          file=sys.stderr, flush=True)


def _embed_grad_check(torch, sess, batch):
    """One step's gradients with the embedding's backward recorded: the
    cotangent (g, ids) the step gives #1, checked against the step's
    tokens, and #1 on it against its plain versions (``_check_embed``)."""
    from repro_torch.engine import single_grad_fn
    (loss, _, grads), calls = _capture_embed(
        lambda: single_grad_fn(sess.model)(sess.state.params, batch))
    del grads
    check = _check_embed(torch, calls, "lm_train")
    g, ids, V, _ = calls[0]
    # the step's token embedding: its ids, one cotangent row each (the
    # tied table's gradient adds the unembedding's to #1's result)
    toks = batch["tokens"]
    if not (torch.equal(ids, toks.reshape(-1).long()) and tuple(g.shape)
            == (toks.numel(), sess.cfg.arch.d_model)):
        fail(f"lm_train: #1 saw ids/cotangent {tuple(ids.shape)} / "
             f"{tuple(g.shape)}, not the step's tokens")
    return float(loss), g, ids, V, check


def _embed_kernel_times(torch, g, ids, V):
    """#1 at the embedding's shape: its time at the default plan and at
    the carried one (``SS_CARRY_PLAN``, the same bits), the plain version
    (an f32 one-hot product), the bf16 one-hot product the embedding's
    backward would be without #1, ``index_add_`` and the byte bound.
    Timed by CUDA events over back-to-back calls (each call takes 0.08 ms
    or more, far above its launch cost): after the LM step's trace,
    ``torch.profiler`` read about half of these kernels' time on an
    H100."""
    import torch.nn.functional as F
    from repro_torch.kernels.segment_sum import ops, segment_sum_ref
    E, D = g.shape
    p = ops.plan(V, E, D, itemsize=g.element_size())
    old = ops.Plan(*SS_CARRY_PLAN)
    out = ops.segment_sum(g, ids, V)
    if not torch.equal(out, ops._launch(g, ids, V, old)):
        fail("lm_train #1: the carried plan gives other bits than this "
             "plan")
    ids64 = ids.long()
    nbytes = E * D * g.element_size() + 4 * E + V * D * g.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = E * D / FP32_FLOPS * 1e3

    def onehot_bf16():
        return F.one_hot(ids64, V).to(g.dtype).T @ g
    ids32 = ids.to(torch.int32)
    return {
        "plan": dict(p._asdict()), "carry_plan": dict(old._asdict()),
        "timer": "cuda events",
        "ms": time_ms(torch, lambda: ops.segment_sum(g, ids32, V), iters=20),
        "carry_plan_ms": time_ms(torch, lambda: ops._launch(g, ids32, V, old),
                                iters=2, warm=1),
        "plain_ms": time_ms(torch, lambda: segment_sum_ref(g, ids, V),
                            iters=3, warm=1),
        "onehot_bf16_ms": time_ms(torch, onehot_bf16, iters=3, warm=1),
        # lint: allow(ATM001): library_ms yardstick, on no port path
        "library_ms": time_ms(torch, lambda: torch.zeros(
            (V, D), dtype=g.dtype, device=g.device).index_add_(0, ids64, g),
            iters=20),
        "library": "index_add_ (bf16, with its zero fill)",
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes}


def _lm_step_times(torch, sess, batch, iters=2):
    """One LM training step on a placed batch: device time (its kernels,
    ``torch.profiler``), the kernels that take most of it, its launches,
    and host-clock ms with the loss read back."""
    step, state = sess.step_fn, sess.state
    prof = device_profile(torch, lambda: step(state, batch), iters=iters,
                          warm=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        float(step(state, batch)[1].loss)
    top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1])[:8]
    return {"device_ms": prof["ms"],
            "host_ms": (time.perf_counter() - t0) / iters * 1e3,
            "kernels_per_step": prof["kernels_per_call"],
            "top_kernels_ms": dict(top)}


def lm_train_phase(torch, counters):
    """qwen1.5-0.5b at full width (24 layers, d=1024, 16 heads, d_ff 2816,
    padded vocab 152064, tied table; bf16 compute over fp32 params drawn on
    the card from a seed; ``impl="chunked"``, per-block remat): (a) ``lm``,
    B=8 x S=1024, 5 AdamW steps; (b) ``lm-mtl``, 4 tasks x 2 x 1024, 3
    steps. #1 takes the embedding's backward, once a step."""
    from repro_torch import interop
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.data.lm_data import make_lm_sources
    cfg = qwen1_5_0_5b.CONFIG
    out = {"phase": "lm_train", "config": cfg.name, "impl": "chunked",
           "remat": cfg.remat, "compute_dtype": "bfloat16",
           "param_dtype": "float32", "seq": LM_S,
           "tolerance": {"embed_grad": "bitwise to the token-order sum; "
                         "the rounding bound of the one-hot product"}}
    others = {k: 0 for k in counters if k != "segment_sum_2d"}

    # (a) lm
    B = LM_B
    source = make_lm_sources(1, 64, LM_S, cfg.vocab)[0]
    sess = _lm_session(cfg, "lm", source, LM_TRAIN_STEPS, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = _counted_run(torch, sess, counters)
    peak = torch.cuda.max_memory_allocated()
    rows = res.logger.history
    losses = [r["loss"] for r in rows]
    if len(losses) != LM_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"lm_train lm: losses {losses}")
    want = {"segment_sum_2d": LM_TRAIN_STEPS, **others}
    if launches != want:
        fail(f"lm_train lm: launches {launches}, the design implies {want} "
             "(one embedding backward a step)")
    batch = {k: torch.from_numpy(v[:B]).to(DEVICE) for k, v in
             source.items()}
    loss1, g, ids, V, check = _embed_grad_check(torch, sess, batch)
    times = _lm_step_times(torch, sess, batch)
    out["lm"] = {"batch": B, "tokens_per_step": B * LM_S,
                 "params": sess.n_params(), "steps": LM_TRAIN_STEPS,
                 "losses": losses, "launches": launches,
                 "launches_per_step": {"segment_sum_2d":
                                       launches["segment_sum_2d"]
                                       / LM_TRAIN_STEPS},
                 "wall_s": wall, "peak_mem_bytes": peak,
                 "step_host_ms_in_run": (rows[-1]["wall"] - rows[1]["wall"])
                 / (LM_TRAIN_STEPS - 2) * 1e3,
                 "step": times, "embed_grad": check}
    del sess, res
    _free(torch)
    kern = _embed_kernel_times(torch, g, ids, V)
    kern.update(max_abs_err=check["bfloat16"]["max_abs_err"],
                shape=check["shape"])
    out["segment_sum_2d"] = kern
    del g, ids
    _free(torch)

    # two 3-step runs from one seed end bitwise equal
    ends = []
    for _ in range(2):
        with _lm_session(cfg, "lm", source, LM_REPLAY_STEPS, B) as s:
            ends.append(interop.leaves(s.run().params))
        _free(torch)
    if not all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0]):
        fail("lm_train: two 3-step runs from one seed end with different "
             "params")
    out["replay_bitwise"] = True
    del ends
    _free(torch)

    # (b) lm-mtl
    mcfg = cfg.replace(n_tasks=LM_TASKS)
    sources = make_lm_sources(LM_TASKS, 16, LM_S, cfg.vocab)
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = _counted_run(
        torch, _lm_session(mcfg, "lm-mtl", sources, LM_MTL_STEPS,
                           LM_TASK_B), counters)
    rows = res.logger.history
    losses = [r["loss"] for r in rows]
    per_task = [[r[f"task{t}"] for t in range(LM_TASKS)] for r in rows]
    if len(losses) != LM_MTL_STEPS or not all(
            map(math.isfinite, losses + sum(per_task, []))):
        fail(f"lm_train lm-mtl: losses {losses}, per task {per_task}")
    want = {"segment_sum_2d": LM_MTL_STEPS, **others}
    if launches != want:
        fail(f"lm_train lm-mtl: launches {launches}, the design implies "
             f"{want} (one trunk pass, one embedding backward a step)")
    out["lm_mtl"] = {"tasks": LM_TASKS, "batch_per_task": LM_TASK_B,
                     "steps": LM_MTL_STEPS, "losses": losses,
                     "per_task": per_task, "launches": launches,
                     "wall_s": wall,
                     "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    del res
    _free(torch)
    out["launches"] = {k: out["lm"]["launches"][k]
                       + out["lm_mtl"]["launches"][k] for k in counters}
    return out


# ---------------------------------------------------------------------------
# phase 6c: the MoE family at full width
# ---------------------------------------------------------------------------

MOE_SERVE = (8, 1024, 32)           # B, prompt, new tokens: lm_serve's (a)
MOE_TF_STEPS = 8                    # teacher-forced decode steps
MOE_ND = (2, 248, 8)                # decode vs the full forward: B, prefill,
                                    # decode steps (the full forward's 2 x
                                    # 256 tokens are one 512-token group)
MOE_TRAIN_B = 2                     # x LM_S tokens a step
MOE_TRAIN_STEPS = 3
DEEPSEEK_LAYERS = (2, 1)            # served, trained (of 60: 7.9 GB a
                                    # layer; the contract's time)
GRANITE_LAYERS = 6                  # served and trained (of 32: the
                                    # contract's time limit)


def _moe_configs():
    """(name, served config, trained config): granite-moe and deepseek-v2
    at full width, cut in depth to ``GRANITE_LAYERS`` and
    ``DEEPSEEK_LAYERS``."""
    from repro_torch.configs import deepseek_v2_236b, granite_moe_3b_a800m
    g, d = granite_moe_3b_a800m.CONFIG, deepseek_v2_236b.CONFIG
    g = g.replace(n_layers=GRANITE_LAYERS)
    return [(g.name, g, g),
            (d.name, d.replace(n_layers=DEEPSEEK_LAYERS[0]),
             d.replace(n_layers=DEEPSEEK_LAYERS[1]))]


def _zero(torch, counters):
    _sync(torch, DEVICE)
    for c in counters.values():
        c.launches = 0


def _moe_generate(torch, params, cfg, prompt, n_new, counters, want,
                  what="lm_moe", media=None, memory=None):
    """One kernel-path generation with the counts zeroed just before it:
    ``greedy_generate(impl="pallas", memory=)``, or with ``media`` (which
    ``greedy_generate`` does not take, as ``repro``'s does not)
    ``make_prefill_step(media=)``, ``extend_caches`` and
    ``make_decode_step`` from ``n_media + S`` on. Tokens, logits and the
    run's numbers."""
    from repro_torch.train.serve import (extend_caches, greedy_generate,
                                         make_decode_step, make_prefill_step)
    torch.cuda.reset_peak_memory_stats()
    _zero(torch, counters)
    B, S = prompt.shape
    n_media = 0 if media is None else media.shape[1]
    timings = {}
    if media is None:
        toks, logits = greedy_generate(params, cfg, prompt, n_new,
                                       impl="pallas", memory=memory,
                                       device=DEVICE, return_logits=True,
                                       timings=timings)
    else:
        decode = make_decode_step(cfg, "pallas")
        t0 = time.perf_counter()
        lg, caches = make_prefill_step(cfg, "pallas")(
            params, prompt.to(DEVICE), media=media)
        caches = extend_caches(caches, cfg, n_media + S + n_new)
        outs = [lg[:, -1:]]
        out = [outs[0].argmax(-1).to(torch.int32)]
        _sync(torch, DEVICE)
        t1 = time.perf_counter()
        pos = torch.tensor(n_media + S, dtype=torch.int64, device=DEVICE)
        for _ in range(n_new - 1):
            lg, caches = decode(params, out[-1], caches, pos)
            outs.append(lg[:, -1:])
            out.append(outs[-1].argmax(-1).to(torch.int32))
            pos = pos + 1
        _sync(torch, DEVICE)
        timings = {"prefill_s": t1 - t0,
                   "decode_s": time.perf_counter() - t1}
        toks, logits = torch.cat(out, 1), torch.cat(outs, 1)
        del caches
    launches = {k: c.launches for k, c in counters.items()}
    if not (toks.shape == (B, n_new) and bool(torch.isfinite(logits).all())
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab):
        fail(f"{what} {cfg.name}: bad tokens or non-finite logits")
    if launches != want:
        fail(f"{what} {cfg.name} serve: launches {launches}, the design "
             f"implies {want}")
    return toks, logits, {
        "batch": B, "media": n_media, "prompt": S, "new": n_new,
        "launches": launches, "prefill_s": timings["prefill_s"],
        "prefill_tok_per_s": B * (n_media + S) / timings["prefill_s"],
        "decode_s": timings["decode_s"],
        "decode_ms_per_step": timings["decode_s"] / (n_new - 1) * 1e3,
        "decode_tok_per_s": B * (n_new - 1) / timings["decode_s"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _profiled(torch, fn, cpu=True):
    """One call of ``fn`` after a warm-up: its device time (kernels,
    ``torch.profiler``; ``cpu=False``: the device traced alone), the
    kernels that take most of it, and the host clock around one
    synchronised call."""
    prof = device_profile(torch, fn, iters=1, warm=1, cpu=cpu)
    _sync(torch, DEVICE)
    t0 = time.perf_counter()
    fn()
    _sync(torch, DEVICE)
    top = sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": prof["ms"],
            "host_ms": (time.perf_counter() - t0) * 1e3,
            "kernels": prof["kernels_per_call"], "top_kernels_ms": dict(top)}


def _moe_serve(torch, cfg, counters):
    """Serve ``cfg`` at full width: two bitwise-equal runs, the kernel
    path's teacher-forced logits against the plain path's, the decode
    against the full forward, and one profiled prefill and decode step."""
    from repro_torch import interop
    from repro_torch.models import transformer
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.lm_init(gen, cfg, device=dev)
    _sync(torch, DEVICE)
    out = {"layers": cfg.n_layers, "init_s": time.perf_counter() - t0,
           "params": sum(x.numel() for x in interop.leaves(params).values()),
           "param_bytes": sum(x.numel() * x.element_size()
                              for x in interop.leaves(params).values())}
    L = cfg.n_layers
    B, S, new = MOE_SERVE
    # #6 takes GQA's decode; MLA decodes absorbed, by plain products
    want = {k: 0 for k in counters}
    want.update(flash_attention=L,
                flash_decode=0 if "mla" in cfg.block_pattern
                else L * (new - 1))
    prompt = _lm_prompts(cfg, B, S, seed=1)
    toks_a, logits_a, run_a = _moe_generate(torch, params, cfg, prompt, new,
                                            counters, want)
    toks_b, logits_b, run_b = _moe_generate(torch, params, cfg, prompt, new,
                                            counters, want)
    if not (torch.equal(toks_a, toks_b) and torch.equal(logits_a,
                                                        logits_b)):
        fail(f"lm_moe {cfg.name}: two kernel-path runs differ bitwise")
    out.update(run_a=run_a, run_b=run_b, replay_bitwise=True)
    del logits_a, logits_b

    # the kernel path's teacher-forced logits against the plain path's
    tf = _lm_prompts(cfg, B, S, extra=MOE_TF_STEPS, seed=1)
    got, _ = _teacher_forced(torch, params, cfg, tf, S, "pallas")
    ref, _ = _teacher_forced(torch, params, cfg, tf, S, "chunked")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    out["teacher_forced"] = {
        "steps": MOE_TF_STEPS, "bf16_max_abs_err": err,
        "bf16_max_abs_logit": scale, "bf16_tolerance": LM_TOL_BF16 * scale,
        "per_step": (got - ref).abs().amax(dim=(1, 2)).tolist(),
        "argmax_agreement": float((got.argmax(-1) == ref.argmax(-1))
                                  .float().mean())}
    if not err <= LM_TOL_BF16 * scale:
        fail(f"lm_moe {cfg.name} teacher-forced bf16 logits: max_abs_err "
             f"{err} > {LM_TOL_BF16}*{scale}")
    del got, ref

    # decode (GQA through #6, MLA absorbed over the latent cache) against
    # the full forward of the same tokens (MLA up-projected, through #5).
    # Capacity is made ample (E / k: no token drops) in both, since the
    # full forward routes 512-token groups and a decode step a group of B
    nd = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    Bn, Sn, Tn = MOE_ND
    toks = _lm_prompts(cfg, Bn, Sn, extra=Tn, seed=3).to(dev)
    with torch.no_grad():
        full = transformer.lm_apply(params, toks, cfg=nd, impl="pallas")[0]
    full = full[:, Sn - 1:, :cfg.vocab].transpose(0, 1)
    dec, _ = _teacher_forced(torch, params, nd, toks, Sn, "pallas")
    scale = float(full.abs().max())
    err = float((dec - full).abs().max())
    out["decode_vs_full_forward"] = {
        "batch": Bn, "prefill": Sn, "steps": Tn,
        "capacity_factor": nd.capacity_factor, "bf16_max_abs_err": err,
        "bf16_max_abs_logit": scale, "bf16_tolerance": LM_TOL_BF16 * scale,
        "argmax_agreement": float((dec.argmax(-1) == full.argmax(-1))
                                  .float().mean())}
    if not err <= LM_TOL_BF16 * scale:
        fail(f"lm_moe {cfg.name} decode vs the full forward: max_abs_err "
             f"{err} > {LM_TOL_BF16}*{scale}")
    del full, dec

    # one profiled prefill and decode step at run (a)'s shape
    prefill = make_prefill_step(cfg, "pallas")
    decode = make_decode_step(cfg, "pallas")
    ptoks = prompt.to(dev)
    out["prefill_profile"] = _profiled(torch, lambda: prefill(params, ptoks))
    _, caches = prefill(params, ptoks)
    caches = extend_caches(caches, cfg, S + 1)
    nxt = toks_a[:, :1]
    out["decode_profile"] = _profiled(
        torch, lambda: decode(params, nxt, caches, S))
    del params, caches
    _free(torch)
    return out


def _moe_train(torch, cfg, counters):
    """Train ``lm`` on ``cfg`` (``impl="chunked"``, per-block remat, the
    donated AdamW update: the state is held once) for ``MOE_TRAIN_STEPS``
    steps of B=2 x 1024, twice from one seed (bitwise), #1 on one step's
    embedding cotangent against its plain versions, and one profiled
    step."""
    from repro_torch import interop
    from repro_torch.data.lm_data import make_lm_source
    from repro_torch.engine import (ShardingPlan, TrainState, build_model,
                                    make_step, single_grad_fn)
    from repro_torch.optim.adamw import adamw
    from repro_torch.train.loop import train_loop
    dev = torch.device(DEVICE)
    model = build_model("lm", cfg)
    opt = adamw(3e-4, donate=True)
    step = ShardingPlan().compile(make_step(model, opt))
    B, n = MOE_TRAIN_B, MOE_TRAIN_STEPS
    src = make_lm_source(5, B * n, LM_S, cfg.vocab, alpha=1.05)
    batches = [{k: torch.from_numpy(v[i * B:(i + 1) * B]).to(dev)
                for k, v in src.items()} for i in range(n)]

    def run():
        state = TrainState.create(model.init(0, dev), opt)
        _zero(torch, counters)
        t0 = time.perf_counter()
        state, logger, _ = train_loop(step, state, iter(batches), steps=n,
                                      log_every=1, eval_every=10 ** 9)
        _sync(torch, DEVICE)
        return state, [r["loss"] for r in logger.history], \
            {k: c.launches for k, c in counters.items()}, \
            time.perf_counter() - t0

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    state, losses, launches, wall = run()
    peak = torch.cuda.max_memory_allocated()
    if len(losses) != n or not all(map(math.isfinite, losses)):
        fail(f"lm_moe {cfg.name} train: losses {losses}")
    want = {k: 0 for k in counters}
    want["segment_sum_2d"] = n
    if launches != want:
        fail(f"lm_moe {cfg.name} train: launches {launches}, the design "
             f"implies {want} (one embedding backward a step)")
    out = {"layers": cfg.n_layers, "batch": B, "seq": LM_S, "steps": n,
           "params": sum(x.numel() for x in
                         interop.leaves(state.params).values()),
           "losses": losses, "launches": launches, "wall_s": wall,
           "peak_mem_bytes": peak,
           "state_bytes": sum(x.numel() * x.element_size() for t in (
               state.params, state.opt_state.m, state.opt_state.v)
               for x in interop.leaves(t).values())}
    ends = {k: v.cpu() for k, v in interop.leaves(state.params).items()}
    del state
    _free(torch)
    state, losses_b, _, _ = run()
    if losses_b != losses or not all(
            torch.equal(v.cpu(), ends[k])
            for k, v in interop.leaves(state.params).items()):
        fail(f"lm_moe {cfg.name} train: two {n}-step runs from one seed "
             "differ")
    out["replay_bitwise"] = True
    del ends
    # #1 on one step's own embedding cotangent, at this config's shape
    (_, _, grads), calls = _capture_embed(
        lambda: single_grad_fn(model)(state.params, batches[0]))
    del grads
    out["embed_grad"] = _check_embed(torch, calls, f"lm_moe {cfg.name}")
    g, ids, V, _ = calls[0]
    del calls
    _free(torch)
    out["segment_sum_2d"] = _embed_times(torch, g, ids, V)
    del g, ids
    _free(torch)
    batch = batches[0]
    out["step_profile"] = _profiled(
        torch, lambda: float(step(state, batch)[1].loss))
    del state
    _free(torch)
    return out


def _embed_times(torch, g, ids, V):
    """#1 at a training path's embedding shape beside its plain version
    (the f32 one-hot product), ``index_add_`` and the byte bound; CUDA
    events over back-to-back calls."""
    from repro_torch.kernels.segment_sum import ops, segment_sum_ref
    E, D = g.shape
    ids32, ids64 = ids.to(torch.int32), ids.long()
    nbytes = E * D * g.element_size() + 4 * E + V * D * g.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = E * D / FP32_FLOPS * 1e3
    return {"shape": [E, V, D], "dtype": str(g.dtype).replace("torch.", ""),
            "plan": dict(ops.plan(V, E, D, itemsize=g.element_size())
                         ._asdict()),
            "timer": "cuda events",
            "ms": time_ms(torch, lambda: ops.segment_sum(g, ids32, V),
                          iters=20),
            "plain_ms": time_ms(torch, lambda: segment_sum_ref(g, ids, V),
                                iters=3, warm=1),
            # lint: allow(ATM001): library_ms yardstick, on no port path
            "library_ms": time_ms(torch, lambda: torch.zeros(
                (V, D), dtype=g.dtype, device=g.device).index_add_(
                    0, ids64, g), iters=20),
            "library": "index_add_ (with its zero fill)",
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


def lm_moe_phase(torch, counters):
    """granite-moe-3b-a800m at full width (d=1536, 24/8 heads of 64, 40
    experts top-8 of width 512, fp32 weights, bf16 compute) cut to
    ``GRANITE_LAYERS`` of its 32 layers, and deepseek-v2-236b at full
    width (d=5120, 128 heads, MLA latent 512 / q 1536, rope 64 + nope 128,
    160 experts top-6 of width 1536 plus 2 shared, bf16 weights) cut to
    ``DEEPSEEK_LAYERS``; weights drawn on the card from a seed."""
    out = {"phase": "lm_moe", "compute_dtype": "bfloat16",
           "serve_impl": "pallas", "train_impl": "chunked",
           "tolerance": {"teacher_forced": f"{LM_TOL_BF16} x max|logit|",
                         "decode_vs_full_forward":
                         f"{LM_TOL_BF16} x max|logit|",
                         "embed_grad": "bitwise to the token-order sum; "
                         "the rounding bound of the one-hot product"},
           "configs": {}}
    _T0[0] = time.perf_counter()
    for name, serve_cfg, train_cfg in _moe_configs():
        rec = {"serve": _moe_serve(torch, serve_cfg, counters)}
        _tick(f"{name} served")
        rec["train"] = _moe_train(torch, train_cfg, counters)
        _tick(f"{name} trained")
        out["configs"][name] = rec
    out["launches"] = {
        k: sum(r["serve"][run]["launches"][k] for r in
               out["configs"].values() for run in ("run_a", "run_b"))
        + sum(r["train"]["launches"][k] for r in out["configs"].values())
        for k in counters}
    return out


# ---------------------------------------------------------------------------
# phase 6d: the recurrent blocks at full width
# ---------------------------------------------------------------------------

REC_SERVE = {"a": (8, 1024, 32),    # B, prompt, new tokens: lm_serve's (a)
             "b": (1, 4200, 16)}    # zamba2 only: past the 4096 window
REC_TF_STEPS = {"a": 8, "b": 4}     # teacher-forced decode steps
REC_ND = (2, 248, 8)                # decode vs the full forward: B,
                                    # prefill, decode steps
REC_TRAIN_B = 8                     # lm training: 8 sequences a step of
REC_TRAIN_S = {"zamba2-1.2b": 1024,  # ... these lengths: xlstm's cut from
               "xlstm-125m": 256}   # 1024, where its sLSTM scan (~20
                                    # launches a token a layer, three
                                    # passes a step under remat) took 20.6
                                    # s a step on the host clock
REC_TRAIN_STEPS = 3
REC_TRAIN_LAYERS = {"zamba2-1.2b": 12}  # trained cut in depth (two shared-
                                    # attention applications), served at
                                    # full depth
REC_ZAMBA_LAYERS = 12               # zamba2 served at two of its six
                                    # units of 38 layers (two shared-
                                    # attention applications: the
                                    # contract's time)
REC_XLSTM_LAYERS = 2                # xlstm served and trained at 2 of 12
                                    # layers (one mLSTM / sLSTM pair): no
                                    # kernel of the port is on its path, and
                                    # its host-bound scans took 82 s at 12
                                    # layers on an NVIDIA H100 80GB HBM3,
                                    # 700.00 W
REC_PROFILE_S = {"xlstm-125m": (256, 64)}  # xlstm's profiled prefill and
                                    # training step: lengths cut so that
                                    # a trace holds ~10^4-10^5 events
_T0 = [time.perf_counter()]


def _tick(msg):
    """Progress on stderr: seconds since the phase began."""
    print(f"chip_smoke: {time.perf_counter() - _T0[0]:8.1f} s {msg}",
          file=sys.stderr, flush=True)


def _recurrent_configs():
    """zamba2-1.2b at full width cut to ``REC_ZAMBA_LAYERS``, xlstm-125m at
    full width cut to ``REC_XLSTM_LAYERS``."""
    from repro_torch.configs import xlstm_125m, zamba2_1_2b
    return [zamba2_1_2b.CONFIG.replace(n_layers=REC_ZAMBA_LAYERS),
            xlstm_125m.CONFIG.replace(n_layers=REC_XLSTM_LAYERS)]


def _tree_bytes(tree):
    """Bytes of the tensors of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _kernel_vs_plain(torch, params, cfg, B, S, steps, seed, what):
    """Teacher-forced logits of the kernel path (``"pallas"``) against the
    plain path's (``"chunked"``) over ``steps`` decode steps after an
    S-token prefill, within ``LM_TOL_BF16`` x max|logit|: the record, and
    the tokens and the kernel path's logits."""
    toks = _lm_prompts(cfg, B, S, extra=steps, seed=seed)
    got, _ = _teacher_forced(torch, params, cfg, toks, S, "pallas")
    ref, _ = _teacher_forced(torch, params, cfg, toks, S, "chunked")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not err <= LM_TOL_BF16 * scale:
        fail(f"{what}: teacher-forced bf16 logits max_abs_err {err} > "
             f"{LM_TOL_BF16}*{scale}")
    return {"batch": B, "prompt": S, "steps": steps, "bf16_max_abs_err": err,
            "bf16_max_abs_logit": scale, "bf16_tolerance": LM_TOL_BF16 * scale,
            "per_step": (got - ref).abs().amax(dim=(1, 2)).tolist(),
            "argmax_agreement": float((got.argmax(-1) == ref.argmax(-1))
                                      .float().mean())}, toks, got


def _rec_serve(torch, cfg, counters):
    """Serve ``cfg`` at full width: run (a) twice (bitwise), run (b) where
    the config has a window, the kernel path's teacher-forced logits
    against the plain path's at both runs' shapes, decode against the full
    forward, one profiled prefill and decode step."""
    from repro_torch import interop
    from repro_torch.models import transformer
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    what = f"lm_recurrent {cfg.name}"
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.lm_init(gen, cfg, device=dev)
    _sync(torch, DEVICE)
    n_attn = sum(bt == "shared_attn" for bt in cfg.pattern)
    out = {"layers": cfg.n_layers, "shared_attn_layers": n_attn,
           "init_s": time.perf_counter() - t0,
           "params": sum(x.numel() for x in
                         interop.leaves(params).values()),
           "param_bytes": _tree_bytes(params)}
    runs = ("a", "b") if cfg.window else ("a",)
    for run in runs:
        _tick(f"{cfg.name} serve run {run}")
        B, S, new = REC_SERVE[run]
        # #5 takes the shared block's prefill, #6 its decode; the recurrent
        # blocks run plain products and scans
        want = {k: 0 for k in counters}
        want.update(flash_attention=n_attn, flash_decode=n_attn * (new - 1))
        prompt = _lm_prompts(cfg, B, S, seed=1 if run == "a" else 2)
        toks, logits, rec = _moe_generate(torch, params, cfg, prompt, new,
                                          counters, want, "lm_recurrent")
        if run == "a":
            toks2, logits2, rec2 = _moe_generate(
                torch, params, cfg, prompt, new, counters, want,
                "lm_recurrent")
            if not (torch.equal(toks, toks2) and torch.equal(logits,
                                                             logits2)):
                fail(f"{what}: two kernel-path runs differ bitwise")
            out["run_a_replay"] = rec2
            out["replay_bitwise"] = True
            first = toks[:, :1]
        out[f"run_{run}"] = rec
        del logits
        out[f"teacher_forced_{run}"] = _kernel_vs_plain(
            torch, params, cfg, B, S, REC_TF_STEPS[run],
            1 if run == "a" else 2, f"{what} run {run}")[0]

    # decode (through #6 for the shared block) against the full forward of
    # the same tokens (through #5): in f32 compute within LM_TOL_F32 (the
    # decode path's arithmetic: a recurrent state stepped a token at a
    # time against chunkwise sums); in bf16 compute, measured against the
    # f32 full forward, no further from it than twice the bf16 full
    # forward itself (or LM_TOL_BF16 x max|logit|, the larger): the step
    # and the chunkwise sums round at other points, and the decoded
    # state's roundings add up over the steps
    _tick(f"{cfg.name} decode vs full forward")
    Bn, Sn, Tn = REC_ND
    toks = _lm_prompts(cfg, Bn, Sn, extra=Tn, seed=3).to(dev)
    cfg32 = cfg.replace(compute_dtype=torch.float32)
    res = {}
    for name, c in (("bf16", cfg), ("f32", cfg32)):
        with torch.no_grad():
            full = transformer.lm_apply(params, toks, cfg=c, impl="pallas")[0]
        res[name] = (full[:, Sn - 1:, :cfg.vocab].transpose(0, 1).float(),
                     _teacher_forced(torch, params, c, toks, Sn,
                                     "pallas")[0].float())
        del full
    (full16, dec16), (full32, dec32) = res["bf16"], res["f32"]
    atol, rtol = LM_TOL_F32
    f32_err = float((dec32 - full32).abs().max())
    scale = float(full32.abs().max())
    err16 = float((dec16 - full16).abs().max())
    dec_off = float((dec16 - full32).abs().max())
    full_off = float((full16 - full32).abs().max())
    tol16 = max(2 * full_off, LM_TOL_BF16 * scale)
    out["decode_vs_full_forward"] = {
        "batch": Bn, "prefill": Sn, "steps": Tn, "f32_max_abs_err": f32_err,
        "f32_tolerance": list(LM_TOL_F32), "bf16_max_abs_err": err16,
        "bf16_per_step": (dec16 - full16).abs().amax(dim=(1, 2)).tolist(),
        "bf16_decode_vs_f32_forward": dec_off,
        "bf16_forward_vs_f32_forward": full_off,
        "bf16_tolerance": tol16, "max_abs_logit": scale,
        "argmax_agreement": float((dec16.argmax(-1) == full16.argmax(-1))
                                  .float().mean())}
    if not torch.allclose(dec32, full32, atol=atol, rtol=rtol):
        fail(f"{what} f32 decode vs the full forward: max_abs_err {f32_err}"
             f" beyond atol {atol} / rtol {rtol}")
    if not dec_off <= tol16:
        fail(f"{what} bf16 decode vs the f32 full forward: max_abs_err "
             f"{dec_off} > {tol16} (the bf16 forward's own: {full_off})")
    del res, full16, dec16, full32, dec32

    # one profiled prefill and decode step at run (a)'s shape; the decode
    # caches' bytes (the recurrent states are fixed-size, the shared
    # block's k/v grow with the cache)
    _tick(f"{cfg.name} profiles")
    B, S, _ = REC_SERVE["a"]
    prefill = make_prefill_step(cfg, "pallas")
    decode = make_decode_step(cfg, "pallas")
    ptoks = _lm_prompts(cfg, B, REC_PROFILE_S.get(cfg.name, (S,))[0],
                        seed=1).to(dev)
    out["prefill_profile"] = dict(
        _profiled(torch, lambda: prefill(params, ptoks), cpu=False),
        shape=list(ptoks.shape))
    ptoks = _lm_prompts(cfg, B, S, seed=1).to(dev)
    _, caches = prefill(params, ptoks)
    caches = extend_caches(caches, cfg, S + 1)
    out["decode_cache_bytes"] = _tree_bytes(caches)
    out["decode_profile"] = _profiled(
        torch, lambda: decode(params, first, caches, S), cpu=False)
    del params, caches
    _free(torch)
    _tick(f"{cfg.name} served")
    return out


def _rec_train(torch, cfg, counters):
    """Train ``lm`` on ``cfg`` through ``Session`` (``impl="chunked"``,
    per-block remat, bf16 compute, AdamW at lr 3e-4) for
    ``REC_TRAIN_STEPS`` steps of ``REC_TRAIN_B`` x ``REC_TRAIN_S`` tokens,
    twice from one seed (bitwise); #1 on one step's embedding cotangent
    against its plain versions and timed at its shape; one profiled
    step."""
    from repro_torch import interop
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.engine import single_grad_fn
    what = f"lm_recurrent {cfg.name}"
    B, S, n = REC_TRAIN_B, REC_TRAIN_S[cfg.name], REC_TRAIN_STEPS
    source = make_lm_sources(1, 64, S, cfg.vocab)[0]
    _tick(f"{cfg.name} train")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    sess = _lm_session(cfg, "lm", source, n, B)
    res, launches, wall = _counted_run(torch, sess, counters)
    peak = torch.cuda.max_memory_allocated()
    rows = res.logger.history
    losses = [r["loss"] for r in rows]
    if len(losses) != n or not all(map(math.isfinite, losses)):
        fail(f"{what} train: losses {losses}")
    want = {k: 0 for k in counters}
    want["segment_sum_2d"] = n
    if launches != want:
        fail(f"{what} train: launches {launches}, the design implies {want} "
             "(one embedding backward a step)")
    out = {"batch": B, "seq": S, "steps": n, "layers": cfg.n_layers,
           "remat": cfg.remat,
           "params": sum(x.numel() for x in
                         interop.leaves(sess.state.params).values()),
           "losses": losses, "launches": launches, "wall_s": wall,
           "step_host_ms_in_run": (rows[-1]["wall"] - rows[0]["wall"])
           / (n - 1) * 1e3,
           "peak_mem_bytes": peak,
           "state_bytes": sum(_tree_bytes(t) for t in (
               sess.state.params, sess.state.opt_state.m,
               sess.state.opt_state.v))}
    ends = {k: v.cpu() for k, v in interop.leaves(res.params).items()}
    del res
    _free(torch)
    _tick(f"{cfg.name} train replay")
    with _lm_session(cfg, "lm", source, n, B) as again:
        res2 = again.run()
    if [r["loss"] for r in res2.logger.history] != losses or not all(
            torch.equal(v.cpu(), ends[k])
            for k, v in interop.leaves(res2.params).items()):
        fail(f"{what} train: two {n}-step runs from one seed differ")
    out["replay_bitwise"] = True
    del res2, ends, again
    _free(torch)

    # #1 on one step's own embedding cotangent, at this config's shape
    _tick(f"{cfg.name} #1 on the embedding's cotangent")
    batch = {k: torch.from_numpy(v[:B]).to(DEVICE) for k, v in
             source.items()}
    (_, _, grads), calls = _capture_embed(
        lambda: single_grad_fn(sess.model)(sess.state.params, batch))
    del grads
    out["embed_grad"] = _check_embed(torch, calls, what)
    g, ids, V, _ = calls[0]
    del calls
    _free(torch)
    out["segment_sum_2d"] = _embed_times(torch, g, ids, V)
    del g, ids
    _free(torch)
    _tick(f"{cfg.name} step profile")
    step, state = sess.step_fn, sess.state
    Sp = REC_PROFILE_S.get(cfg.name, (S, S))[1]
    pbatch = {k: v[:, :Sp].contiguous() for k, v in batch.items()}
    out["step_profile"] = dict(_profiled(
        torch, lambda: float(step(state, pbatch)[1].loss), cpu=False),
        shape=[B, Sp])
    del sess, state, step
    _free(torch)
    _tick(f"{cfg.name} trained")
    return out


def lm_recurrent_phase(torch, counters):
    """zamba2-1.2b (38 layers, d=2048: 32 Mamba2 blocks of 64 heads, state
    64, and the shared attention block, 32 heads of 64, window 4096,
    applied at 6 of them through per-layer LoRA adapters) and xlstm-125m
    (d=768, mLSTM and sLSTM in turn) at full width, zamba2 served at full
    depth and trained cut (``REC_TRAIN_LAYERS``), xlstm at
    ``REC_XLSTM_LAYERS`` of its 12 layers; fp32 weights drawn on the card
    from a seed, bf16 compute."""
    out = {"phase": "lm_recurrent", "compute_dtype": "bfloat16",
           "serve_impl": "pallas", "train_impl": "chunked",
           "tolerance": {"teacher_forced": f"{LM_TOL_BF16} x max|logit|",
                         "decode_vs_full_forward":
                         f"f32: atol/rtol {LM_TOL_F32}; bf16: against the "
                         "f32 forward, max(2 x the bf16 forward's own "
                         f"error, {LM_TOL_BF16} x max|logit|)",
                         "embed_grad": "bitwise to the token-order sum; "
                         "the rounding bound of the one-hot product"},
           "configs": {}}
    _T0[0] = time.perf_counter()
    for cfg in _recurrent_configs():
        t0 = time.perf_counter()
        rec = {"serve": _rec_serve(torch, cfg, counters)}
        rec["train"] = _rec_train(torch, cfg.replace(
            n_layers=REC_TRAIN_LAYERS.get(cfg.name, cfg.n_layers)), counters)
        rec["wall_s"] = time.perf_counter() - t0
        out["configs"][cfg.name] = rec
    out["launches"] = {
        k: sum(r["serve"][run]["launches"][k] for r in
               out["configs"].values()
               for run in ("run_a", "run_a_replay", "run_b")
               if run in r["serve"])
        + sum(r["train"]["launches"][k] for r in out["configs"].values())
        for k in counters}
    return out


# ---------------------------------------------------------------------------
# phase 6e: the frontends and the encoder-decoder at full width
# ---------------------------------------------------------------------------

FRONT_SERVE = {"internvl2-1b": (8, 768, 32),   # B, text prompt, new tokens
               "seamless-m4t-medium": (8, 1024, 32)}
FRONT_TF_STEPS = 8                  # teacher-forced decode steps
FRONT_ND = (2, 248, 8)              # decode vs the full forward: B, text
                                    # prefill, decode steps
FRONT_TRAIN = {"internvl2-1b": (8, 768),       # B, text tokens a sequence
               "seamless-m4t-medium": (2, 1024)}  # cut from 8: the encoder
                                    # keeps every layer's attention
                                    # probabilities under autograd (no
                                    # remat, as repro's), ~2.1 GB a layer
                                    # at B=2 x 4096 frames
FRONT_TRAIN_LAYERS = {"seamless-m4t-medium": 6}  # trained cut in depth
                                    # (6 of 12 decoder and 6 of 12 encoder
                                    # layers)
FRONT_SERVE_LAYERS = {"internvl2-1b": 8,         # of 24 and of 12 + 12:
                      "seamless-m4t-medium": 4}  # the contract's time
FRONT_TRAIN_STEPS = 3
FRONT_SOURCE_ROWS = 16              # sequences in each training source


def _frontend_configs():
    """internvl2-1b and seamless-m4t-medium at full width, cut in depth to
    ``FRONT_SERVE_LAYERS`` (seamless: decoder and encoder alike)."""
    from repro_torch.configs import internvl2_1b, seamless_m4t_medium
    i, s = internvl2_1b.CONFIG, seamless_m4t_medium.CONFIG
    cut = FRONT_SERVE_LAYERS
    return [i.replace(n_layers=cut[i.name]),
            s.replace(n_layers=cut[s.name], n_enc_layers=cut[s.name])]


def _frames(torch, B, n, seed):
    """Seeded stand-ins for the frontend stubs' embeddings (B, n, 1024),
    f32, drawn on the card."""
    from repro_torch.models.frontends import VISION_EMBED_DIM
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return torch.randn((B, n, VISION_EMBED_DIM), generator=gen,
                       device=DEVICE)


def _front_serve(torch, cfg, counters):
    """Serve ``cfg`` at full width, weights drawn on the card: seamless's
    encoder over B x 4096 frames (kernel path against the plain path),
    then generation twice (bitwise), the kernel path's teacher-forced
    logits against the plain path's, decode against the full forward,
    profiles of a prefill and a decode step (and of seamless's encoder,
    and its f32 unembedding's share of the prefill)."""
    from repro_torch import interop
    from repro_torch.models import transformer
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    what = f"lm_frontends {cfg.name}"
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.lm_init(gen, cfg, device=dev)
    _sync(torch, DEVICE)
    leaves = interop.leaves(params)
    out = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "init_s": time.perf_counter() - t0,
           "params": sum(x.numel() for x in leaves.values()),
           "params_by_part": {part: sum(
               x.numel() for k, x in leaves.items()
               if k.split("/")[0] == part)
               for part in ("embed", "scan", "projector", "enc")},
           "param_bytes": _tree_bytes(params)}
    del leaves
    B, S, new = FRONT_SERVE[cfg.name]
    L = cfg.n_layers
    media = memory = None
    if cfg.n_enc_layers:
        _tick(f"{cfg.name} encode")
        src = _frames(torch, B, cfg.enc_memory_len, seed=11)
        _zero(torch, counters)
        with torch.no_grad():
            memory = transformer.encode(params, src, cfg, impl="pallas")
            _sync(torch, DEVICE)
            enc_launches = {k: c.launches for k, c in counters.items()}
            plain = transformer.encode(params, src, cfg, impl="chunked")
        scale = float(plain.float().abs().max())
        err = float((memory.float() - plain.float()).abs().max())
        want = {k: 0 for k in counters}
        want["flash_attention"] = cfg.n_enc_layers
        if enc_launches != want:
            fail(f"{what} encode: launches {enc_launches}, the design "
                 f"implies {want}")
        if not (bool(torch.isfinite(memory).all())
                and err <= LM_TOL_BF16 * scale):
            fail(f"{what} encode: memory max_abs_err {err} > "
                 f"{LM_TOL_BF16}*{scale} (or not finite)")
        del plain
        with torch.no_grad():
            prof = _profiled(torch, lambda: transformer.encode(
                params, src, cfg, impl="pallas"), cpu=False)
        out["encode"] = dict(prof, batch=B, frames=cfg.enc_memory_len,
                             launches=enc_launches, max_abs_err=err,
                             max_abs_memory=scale,
                             tolerance=LM_TOL_BF16 * scale,
                             frames_per_s=B * cfg.enc_memory_len
                             / (prof["host_ms"] * 1e-3))
        del src
        # #5 twice a layer a prefill (causal self, cross); a decode step
        # #6 once a layer (self) and #5 once (cross, one query)
        want = {k: 0 for k in counters}
        want.update(flash_attention=2 * L + L * (new - 1),
                    flash_decode=L * (new - 1))
    else:
        media = _frames(torch, B, cfg.n_media_tokens, seed=12)
        want = {k: 0 for k in counters}
        want.update(flash_attention=L, flash_decode=L * (new - 1))
    _tick(f"{cfg.name} serve")
    prompt = _lm_prompts(cfg, B, S, seed=1)
    toks, logits, rec = _moe_generate(torch, params, cfg, prompt, new,
                                      counters, want, "lm_frontends", media,
                                      memory)
    toks2, logits2, rec2 = _moe_generate(torch, params, cfg, prompt, new,
                                         counters, want, "lm_frontends",
                                         media, memory)
    if not (torch.equal(toks, toks2) and torch.equal(logits, logits2)):
        fail(f"{what}: two kernel-path runs differ bitwise")
    out.update(run_a=rec, run_a_replay=rec2, replay_bitwise=True)
    first = toks[:, :1]
    del logits, logits2, toks2

    # the kernel path's teacher-forced logits against the plain path's
    _tick(f"{cfg.name} teacher forced")
    tf = _lm_prompts(cfg, B, S, extra=FRONT_TF_STEPS, seed=1)
    got, _ = _teacher_forced(torch, params, cfg, tf, S, "pallas", media,
                             memory)
    ref, _ = _teacher_forced(torch, params, cfg, tf, S, "chunked", media,
                             memory)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if not err <= LM_TOL_BF16 * scale:
        fail(f"{what}: teacher-forced bf16 logits max_abs_err {err} > "
             f"{LM_TOL_BF16}*{scale}")
    out["teacher_forced"] = {
        "batch": B, "prompt": S, "steps": FRONT_TF_STEPS,
        "bf16_max_abs_err": err, "bf16_max_abs_logit": scale,
        "bf16_tolerance": LM_TOL_BF16 * scale,
        "per_step": (got - ref).abs().amax(dim=(1, 2)).tolist(),
        "argmax_agreement": float((got.argmax(-1) == ref.argmax(-1))
                                  .float().mean())}
    del got, ref

    # decode (#6, and #5 for the cross-attention) against the full forward
    # of the same tokens (#5)
    _tick(f"{cfg.name} decode vs full forward")
    Bn, Sn, Tn = FRONT_ND
    nd = _lm_prompts(cfg, Bn, Sn, extra=Tn, seed=3)
    m_n = None if media is None else media[:Bn]
    k_n = None if memory is None else memory[:Bn]
    n = 0 if media is None else media.shape[1]
    with torch.no_grad():
        full = transformer.lm_apply(params, nd.to(dev), cfg=cfg, media=m_n,
                                    memory=k_n, impl="pallas")[0]
    full = full[:, n + Sn - 1:, :cfg.vocab].transpose(0, 1)
    dec, _ = _teacher_forced(torch, params, cfg, nd, Sn, "pallas", m_n, k_n)
    scale = float(full.abs().max())
    err = float((dec - full).abs().max())
    if not err <= LM_TOL_BF16 * scale:
        fail(f"{what}: bf16 decode vs the full forward max_abs_err {err} > "
             f"{LM_TOL_BF16}*{scale}")
    out["decode_vs_full_forward"] = {
        "batch": Bn, "prefill": Sn, "media": n, "steps": Tn,
        "bf16_max_abs_err": err, "bf16_tolerance": LM_TOL_BF16 * scale,
        "per_step": (dec - full).abs().amax(dim=(1, 2)).tolist(),
        "argmax_agreement": float((dec.argmax(-1) == full.argmax(-1))
                                  .float().mean())}
    del full, dec

    # one profiled prefill and decode step at the served shape; seamless's
    # f32 unembedding alone beside its prefill
    _tick(f"{cfg.name} profiles")
    prefill = make_prefill_step(cfg, "pallas")
    decode = make_decode_step(cfg, "pallas")
    ptoks = prompt.to(dev)
    out["prefill_profile"] = dict(_profiled(
        torch, lambda: prefill(params, ptoks, media=media, memory=memory),
        cpu=False), shape=[B, n + S])
    _, caches = prefill(params, ptoks, media=media, memory=memory)
    caches = extend_caches(caches, cfg, n + S + 1)
    out["decode_cache_bytes"] = _tree_bytes(caches)
    out["decode_profile"] = _profiled(
        torch, lambda: decode(params, first, caches, n + S, memory=memory),
        cpu=False)
    del caches
    hidden = torch.randn((B, n + S, cfg.d_model), generator=gen,
                         device=dev).to(cfg.compute_dtype)
    unembed_ms = device_ms(torch, lambda: transformer.lm_logits(
        params, hidden, cfg), iters=3, warm=1)
    out["unembed"] = {
        "device_ms": unembed_ms, "shape": [B, n + S, cfg.padded_vocab],
        "share_of_prefill": unembed_ms
        / out["prefill_profile"]["device_ms"]}
    del params, hidden, media, memory
    _free(torch)
    _tick(f"{cfg.name} served")
    return out


def _front_source(torch, cfg, B, S):
    """``FRONT_SOURCE_ROWS`` ``lm_data`` sequences of S tokens, with
    seeded frames beside them: internvl2's 256 media a sequence,
    seamless's 4096 source frames (host numpy, f32)."""
    import numpy as np

    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.models.frontends import VISION_EMBED_DIM
    src = make_lm_sources(1, FRONT_SOURCE_ROWS, S, cfg.vocab)[0]
    rng = np.random.default_rng(21)
    n, key = ((cfg.enc_memory_len, "src_embed") if cfg.n_enc_layers
              else (cfg.n_media_tokens, "media"))
    src[key] = rng.standard_normal((FRONT_SOURCE_ROWS, n, VISION_EMBED_DIM),
                                   dtype=np.float32)
    return src


def _front_train(torch, cfg, counters):
    """Train ``lm`` on ``cfg`` with its frames (internvl2's media,
    seamless's ``src_embed`` encoded inside the loss) through ``Session``
    (``impl="chunked"``, per-block remat in the decoder, bf16 compute,
    AdamW at lr 3e-4) for ``FRONT_TRAIN_STEPS`` steps (``_train_twice``),
    seamless cut in depth (``FRONT_TRAIN_LAYERS``). One session's state
    lives at a time."""
    B, S = FRONT_TRAIN[cfg.name]
    if cfg.name in FRONT_TRAIN_LAYERS:
        cut = FRONT_TRAIN_LAYERS[cfg.name]
        cfg = cfg.replace(n_layers=cut, n_enc_layers=cut)
    frames = cfg.enc_memory_len if cfg.n_enc_layers else cfg.n_media_tokens
    return _train_twice(torch, cfg, counters, _front_source(torch, cfg, B, S),
                        B, S, FRONT_TRAIN_STEPS, f"lm_frontends {cfg.name}",
                        text=S, frames=frames, enc_layers=cfg.n_enc_layers)


def _train_twice(torch, cfg, counters, source, B, S, n, what, **info):
    """``lm`` on ``cfg`` through ``Session`` for n steps of B sequences of
    ``source``, twice from one seed (bitwise); #1 on one step's embedding
    cotangent against its plain versions and timed at its shape; one
    profiled step; peak memory. ``info`` leads the record."""
    from repro_torch import interop
    from repro_torch.engine import single_grad_fn
    _tick(f"{cfg.name} train")
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    sess = _lm_session(cfg, "lm", source, n, B)
    res, launches, wall = _counted_run(torch, sess, counters)
    peak = torch.cuda.max_memory_allocated()
    rows = res.logger.history
    losses = [r["loss"] for r in rows]
    if len(losses) != n or not all(map(math.isfinite, losses)):
        fail(f"{what} train: losses {losses}")
    want = {k: 0 for k in counters}
    want["segment_sum_2d"] = n
    if launches != want:
        fail(f"{what} train: launches {launches}, the design implies {want} "
             "(one embedding backward a step)")
    out = {"batch": B, **info, "steps": n, "layers": cfg.n_layers,
           "remat": cfg.remat, "donate": sess.plan.donate,
           "params": sum(x.numel() for x in
                         interop.leaves(sess.state.params).values()),
           "losses": losses, "launches": launches,
           "wall_s": wall,
           "step_host_ms_in_run": (rows[-1]["wall"] - rows[0]["wall"])
           / (n - 1) * 1e3,
           "peak_mem_bytes": peak,
           "state_bytes": sum(_tree_bytes(t) for t in (
               sess.state.params, sess.state.opt_state.m,
               sess.state.opt_state.v))}
    # a copy: the donated steps profiled below update these params in place
    ends = {k: v.to("cpu", copy=True)
            for k, v in interop.leaves(res.params).items()}
    del res
    _free(torch)

    _tick(f"{cfg.name} #1 on the embedding's cotangent")
    batch = {k: torch.from_numpy(v[:B]).to(DEVICE) for k, v in
             source.items()}
    (_, _, grads), calls = _capture_embed(
        lambda: single_grad_fn(sess.model)(sess.state.params, batch))
    del grads
    out["embed_grad"] = _check_embed(torch, calls, what)
    g, ids, V, _ = calls[0]
    del calls
    _free(torch)
    out["segment_sum_2d"] = _embed_times(torch, g, ids, V)
    del g, ids
    _free(torch)
    _tick(f"{cfg.name} step profile")
    step, state = sess.step_fn, sess.state
    out["step_profile"] = dict(_profiled(
        torch, lambda: float(step(state, batch)[1].loss), cpu=False),
        shape=[B, S])
    out["peak_mem_bytes_with_profile"] = torch.cuda.max_memory_allocated()
    del sess, state, step, batch
    _free(torch)

    _tick(f"{cfg.name} train replay")
    with _lm_session(cfg, "lm", source, n, B) as again:
        res2 = again.run()
    if [r["loss"] for r in res2.logger.history] != losses or not all(
            torch.equal(v.cpu(), ends[k])
            for k, v in interop.leaves(res2.params).items()):
        fail(f"{what} train: two {n}-step runs from one seed differ")
    out["replay_bitwise"] = True
    del res2, ends, again
    _free(torch)
    _tick(f"{cfg.name} trained")
    return out


def lm_frontends_phase(torch, counters):
    """internvl2-1b (24 layers, d=896, 14/2 heads of 64, a vision
    projector's 256 media before the text) and seamless-m4t-medium (12
    encoder and 12 decoder layers, d=1024, 16 heads of 64, an audio
    projector, cross-attention to 4096 frames) at full width, cut in
    depth to ``FRONT_SERVE_LAYERS``, fp32 weights drawn on the card from a
    seed, bf16 compute."""
    out = {"phase": "lm_frontends", "compute_dtype": "bfloat16",
           "serve_impl": "pallas", "train_impl": "chunked",
           "tolerance": {"teacher_forced": f"{LM_TOL_BF16} x max|logit|",
                         "encoder_memory": f"{LM_TOL_BF16} x max|memory|",
                         "decode_vs_full_forward":
                         f"{LM_TOL_BF16} x max|logit|",
                         "embed_grad": "bitwise to the token-order sum; "
                         "the rounding bound of the one-hot product"},
           "configs": {}}
    _T0[0] = time.perf_counter()
    for cfg in _frontend_configs():
        t0 = time.perf_counter()
        rec = {"serve": _front_serve(torch, cfg, counters)}
        rec["train"] = _front_train(torch, cfg, counters)
        rec["wall_s"] = time.perf_counter() - t0
        out["configs"][cfg.name] = rec
    out["launches"] = {
        k: sum(r["serve"][run]["launches"][k]
               for r in out["configs"].values()
               for run in ("run_a", "run_a_replay"))
        + sum(r["serve"].get("encode", {}).get("launches", {}).get(k, 0)
              for r in out["configs"].values())
        + sum(r["train"]["launches"][k] for r in out["configs"].values())
        for k in counters}
    return out


# ---------------------------------------------------------------------------
# phase 6f: the 12 B dense models, gemma3-12b and stablelm-12b
# ---------------------------------------------------------------------------

DENSE_SERVE = {"a": (8, 1024, 32),  # B, prompt, new tokens: lm_serve's (a)
               "b": (1, 4200, 16)}  # gemma3 only: past its 1024 window
DENSE_TF_STEPS = {"a": 8, "b": 4}   # teacher-forced decode steps
DENSE_ND = (2, 248, 8)              # decode vs the full forward under
                                    # gemma3's window: B, prefill, steps
DENSE_SERVE_LAYERS = {"gemma3-12b": 6,      # one 5:1 unit of 48 layers
                      "stablelm-12b": 6}    # of 40: the contract's time
DENSE_TRAIN_LAYERS = {"gemma3-12b": 6,      # one 5:1 unit of 48 layers
                      "stablelm-12b": 8}    # of 40: each cut in depth only
DENSE_TRAIN_B = 2                   # x LM_S tokens a step
DENSE_TRAIN_STEPS = 3
DENSE_PEAK_LIMIT = 75e9             # bytes: no run of the phase above it


def _dense_configs():
    """gemma3-12b and stablelm-12b at full width, cut in depth to
    ``DENSE_SERVE_LAYERS``."""
    from repro_torch.configs import gemma3_12b, stablelm_12b
    return [c.replace(n_layers=DENSE_SERVE_LAYERS[c.name])
            for c in (gemma3_12b.CONFIG, stablelm_12b.CONFIG)]


def _full_logits(torch, params, cfg, toks, S):
    """The full forward's logits (``impl="pallas"``) at positions S - 1
    onwards, (steps + 1, B, vocab) as ``_teacher_forced`` gives its own:
    the unembedding takes only those positions, so no (B, S, vocab) f32
    tensor of every position is made."""
    from repro_torch.models import transformer
    dev = params["embed"]["table"].device
    toks = toks.to(dev)
    with torch.no_grad():
        x = transformer.embed_inputs(params, toks, cfg)
        h, _, _ = transformer.run_trunk(
            params, x, cfg=cfg, positions=torch.arange(toks.shape[1],
                                                       device=dev),
            mode="train", impl="pallas")
        logits = transformer.lm_logits(params, h[:, S - 1:], cfg)
    return logits.transpose(0, 1)[..., :cfg.vocab]


def _dense_teacher_forced(torch, params, cfg, B, S, steps, seed, what):
    """Prefill S tokens and decode ``steps`` more fed the true tokens: the
    kernel path's logits against the plain path's (``"chunked"``) within
    ``LM_TOL_BF16`` x max|logit|, and against the full forward of the same
    tokens (teacher forcing). Where ``repro``'s cache rule keeps every
    k/v cache at the prompt's length (a windowed config, a prompt at least
    the window long: the full-attention layers' caches too, so a decode
    step overwrites their oldest slot) the departure from teacher forcing
    is reported, not gated; else it is held to the same tolerance."""
    out, toks, got = _kernel_vs_plain(torch, params, cfg, B, S, steps, seed,
                                      what)
    full = _full_logits(torch, params, cfg, toks, S)
    kept = bool(cfg.window) and S >= cfg.window
    dep = float((got - full).abs().max())
    fscale = float(full.abs().max())
    out["vs_teacher_forcing"] = {
        "max_abs_err": dep, "tolerance": LM_TOL_BF16 * fscale,
        "per_step": (got - full).abs().amax(dim=(1, 2)).tolist(),
        "argmax_agreement": float((got.argmax(-1) == full.argmax(-1))
                                  .float().mean()),
        "gated": not kept}
    if kept:
        out["vs_teacher_forcing"]["why_not_gated"] = (
            f"prompt {S} >= window {cfg.window}: repro's extend_caches "
            "keeps every k/v cache at the prompt's length, the full-"
            "attention layers' too, so each decode step overwrites their "
            "oldest slot, which teacher forcing still attends")
    elif not dep <= LM_TOL_BF16 * fscale:
        fail(f"{what}: decode vs teacher forcing max_abs_err {dep} > "
             f"{LM_TOL_BF16}*{fscale}")
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _dense_serve(torch, cfg, counters):
    """Serve ``cfg`` (full width, cut in depth) with weights drawn on the card:
    run (a) twice (bitwise) and, where the config has a window, run (b)
    past it; the kernel path's teacher-forced logits against the plain
    path's at both runs' shapes and against teacher forcing (gated under
    the window at ``DENSE_ND``); one profiled prefill and decode step, and
    the f32 unembedding beside the prefill. One model lives at a time."""
    from repro_torch import interop
    from repro_torch.models import transformer
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    what = f"lm_dense12b {cfg.name}"
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    _tick(f"{cfg.name} init")
    t0 = time.perf_counter()
    params = transformer.lm_init(gen, cfg, device=dev)
    _sync(torch, DEVICE)
    L = cfg.n_layers
    out = {"layers": L, "pattern": list(cfg.block_pattern),
           "window": cfg.window, "init_s": time.perf_counter() - t0,
           "params": sum(x.numel() for x in
                         interop.leaves(params).values()),
           "param_bytes": _tree_bytes(params)}
    peaks = []
    for run in ("a", "b") if cfg.window else ("a",):
        _tick(f"{cfg.name} serve run {run}")
        B, S, new = DENSE_SERVE[run]
        want = {k: 0 for k in counters}
        want.update(flash_attention=L, flash_decode=L * (new - 1))
        seed = 1 if run == "a" else 2
        prompt = _lm_prompts(cfg, B, S, seed=seed)
        toks, logits, rec = _moe_generate(torch, params, cfg, prompt, new,
                                          counters, want, "lm_dense12b")
        peaks.append(rec["peak_mem_bytes"])
        if run == "a":
            toks2, logits2, rec2 = _moe_generate(
                torch, params, cfg, prompt, new, counters, want,
                "lm_dense12b")
            if not (torch.equal(toks, toks2) and torch.equal(logits,
                                                             logits2)):
                fail(f"{what}: two kernel-path runs differ bitwise")
            out["run_a_replay"] = rec2
            out["replay_bitwise"] = True
            first = toks[:, :1]
            del logits2
        out[f"run_{run}"] = rec
        del logits
        _tick(f"{cfg.name} teacher-forced run {run}")
        torch.cuda.reset_peak_memory_stats()
        out[f"teacher_forced_{run}"] = _dense_teacher_forced(
            torch, params, cfg, B, S, DENSE_TF_STEPS[run], seed,
            f"{what} run {run}")
        peaks.append(out[f"teacher_forced_{run}"]["peak_mem_bytes"])
    if cfg.window:
        Bn, Sn, Tn = DENSE_ND
        out["decode_vs_full_forward"] = _dense_teacher_forced(
            torch, params, cfg, Bn, Sn, Tn, 3, f"{what} under the window")

    _tick(f"{cfg.name} profiles")
    B, S, _ = DENSE_SERVE["a"]
    prefill = make_prefill_step(cfg, "pallas")
    decode = make_decode_step(cfg, "pallas")
    ptoks = _lm_prompts(cfg, B, S, seed=1).to(dev)
    out["prefill_profile"] = dict(
        _profiled(torch, lambda: prefill(params, ptoks), cpu=False),
        shape=[B, S])
    _, caches = prefill(params, ptoks)
    caches = extend_caches(caches, cfg, S + 1)
    out["decode_cache_bytes"] = _tree_bytes(caches)
    out["decode_profile"] = _profiled(
        torch, lambda: decode(params, first, caches, S), cpu=False)
    del caches
    hidden = torch.randn((B, S, cfg.d_model), generator=gen,
                         device=dev).to(cfg.compute_dtype)
    unembed_ms = device_ms(torch, lambda: transformer.lm_logits(
        params, hidden, cfg), iters=3, warm=1)
    out["unembed"] = {
        "device_ms": unembed_ms, "shape": [B, S, cfg.padded_vocab],
        "share_of_prefill": unembed_ms
        / out["prefill_profile"]["device_ms"]}
    out["peak_mem_bytes"] = max(peaks)
    if not out["peak_mem_bytes"] <= DENSE_PEAK_LIMIT:
        fail(f"{what}: peak {out['peak_mem_bytes']} bytes > "
             f"{DENSE_PEAK_LIMIT}")
    del params, hidden
    _free(torch)
    _tick(f"{cfg.name} served")
    return out


def _dense_train(torch, cfg, counters):
    """``lm`` on ``cfg`` cut to ``DENSE_TRAIN_LAYERS`` at full width,
    through ``Session`` (``donate=True``, the default: the AdamW update in
    the params' and moments' own storage; ``impl="chunked"``, per-block
    remat, bf16 compute, lr 3e-4) for ``DENSE_TRAIN_STEPS`` steps of
    ``DENSE_TRAIN_B`` x 1024 tokens (``_train_twice``)."""
    from repro_torch.configs import get
    from repro_torch.data.lm_data import make_lm_sources
    cut = cfg.replace(n_layers=DENSE_TRAIN_LAYERS[cfg.name])
    source = make_lm_sources(1, 16, LM_S, cut.vocab)[0]
    out = _train_twice(torch, cut, counters, source, DENSE_TRAIN_B, LM_S,
                       DENSE_TRAIN_STEPS, f"lm_dense12b {cfg.name}",
                       seq=LM_S, layers_of=get(cfg.name).n_layers)
    for key in ("peak_mem_bytes", "peak_mem_bytes_with_profile"):
        if not out[key] <= DENSE_PEAK_LIMIT:
            fail(f"lm_dense12b {cfg.name} train: {key} {out[key]} > "
                 f"{DENSE_PEAK_LIMIT}")
    return out


def lm_dense12b_phase(torch, counters):
    """gemma3-12b (48 layers, d=3840, 16 / 8 heads of 256, five sliding-
    window layers (1024) to one full-attention layer, vocab 262,144, θ 1e6)
    and stablelm-12b (40 layers, d=5120, 32 / 8 heads of 160, vocab
    100,352) at full width, served cut in depth to ``DENSE_SERVE_LAYERS``
    (12 / 12) and trained cut to ``DENSE_TRAIN_LAYERS``; fp32 weights
    drawn on the card from a seed, bf16 compute."""
    out = {"phase": "lm_dense12b", "compute_dtype": "bfloat16",
           "serve_impl": "pallas", "train_impl": "chunked",
           "tolerance": {"teacher_forced": f"{LM_TOL_BF16} x max|logit|",
                         "decode_vs_teacher_forcing":
                         f"{LM_TOL_BF16} x max|logit| where no cache is "
                         "kept at the prompt's length; else reported",
                         "embed_grad": "bitwise to the token-order sum; "
                         "the rounding bound of the one-hot product",
                         "peak_mem_bytes": DENSE_PEAK_LIMIT},
           "configs": {}}
    _T0[0] = time.perf_counter()
    for cfg in _dense_configs():
        t0 = time.perf_counter()
        rec = {"serve": _dense_serve(torch, cfg, counters)}
        rec["train"] = _dense_train(torch, cfg, counters)
        rec["wall_s"] = time.perf_counter() - t0
        out["configs"][cfg.name] = rec
    out["launches"] = {
        k: sum(r["serve"][run]["launches"][k]
               for r in out["configs"].values()
               for run in ("run_a", "run_a_replay", "run_b")
               if run in r["serve"])
        + sum(r["train"]["launches"][k] for r in out["configs"].values())
        for k in counters}
    return out


# ---------------------------------------------------------------------------
# phase 6g: training across ranks — data parallelism, lm-mtl over a task's
# ranks, accumulation, the MoE balance term, the resilient runner
# ---------------------------------------------------------------------------

DIST_WORLD = 2                      # ranks of the one job, on the one card
DIST_STEPS = 2                      # steps of each case (a)-(d): at 3,
                                    # lm-mtl's rounding drift reached 1.67
                                    # x the tolerance; one process summing
                                    # in the ranks' order drifts the same
                                    # (PERF.md §7)
DIST_LM = (2, 512)                  # a rank's LM rows a step: B x S tokens
DIST_MOE_LAYERS = 2                 # granite-moe trained at 2 of 32 layers
DIST_SOAK_STEPS = 12                # accepted steps of the soak (e)
DIST_TIMEOUT_S = 600                # the job, spawn to exit
DIST_V_TOL = 1e-3                   # relative: the sum of AdamW's v (a
                                    # gradient off by c moves it by c^2)
DIST_CASES = ("finetune", "lm", "lm_accum2", "lm_mtl", "moe")
MTL_TP_LAYERS = 2                   # (j): qwen's lm-mtl trunk, 2 of 24
MTL_TP_TASKS = 4                    # (j): per-source heads, 2 a model rank
XATTN_LAYERS = (2, 2)               # (k): seamless's encoder + decoder
                                    # layers, of 12 + 12
XATTN_FRAMES = 1024                 # (k): source frames a served row
DIST_SPEC_MESH = (2, 2)             # (f)-(i): the spec_fn plans computed
                                    # tensor-parallel, (data, model): a
                                    # job of its own, 4 ranks
DIST_DP_SPEC_MESH = (1, 2)          # (d'): xlstm's spec_fn plan, in the
                                    # 2-rank job
SPEC_CASES = {                      # case: (arch of the spec, fsdp, mesh)
    "dp_spec": ("xlstm", False, DIST_DP_SPEC_MESH),
    "lm_spec": ("qwen", True, DIST_SPEC_MESH),
    "moe_tp": ("moe", True, DIST_SPEC_MESH),
    "mtl_tp": ("qwen_mtl", True, DIST_SPEC_MESH)}
SERVE_CASES = {                     # case: (arch of the spec, fsdp)
    "tp_serve": ("qwen", True),
    "mla_serve": ("deepseek", False),
    "xattn_serve": ("seamless", False)}
DIST_TP_NEW = 8                     # (g), (i): greedy tokens after the
                                    # prefill
NEAR_TIE_REL = 2.0 ** -6            # (i): a router near-tie, the k-th and
                                    # (k+1)-th probabilities of a token
                                    # within two bf16 roundings (2^-7 each:
                                    # 8 significant bits) of each other


def _tp_layout(cfg, plan, layout) -> dict | None:
    """What a rank of a tensor-parallel ``spec_fn`` plan computes (None:
    the plan keeps the data-parallel step): its q heads (GQA's or MLA's),
    its experts' range, whether ``d_ff_expert`` and the vocab are cut."""
    from repro_torch.configs.sharding import (MODEL, mesh_shape,
                                             tensor_parallel_family)
    m = mesh_shape(plan.mesh)[MODEL]
    if not tensor_parallel_family(cfg, m):
        return None
    tp = plan.tensor_parallel(layout)
    return {"heads": cfg.n_heads // m if tp.heads or tp.mla
            else cfg.n_heads, "mla": tp.mla,
            "experts": list(tp.experts) if tp.experts else None,
            "expert_ffn": tp.expert_ffn, "vocab": tp.vocab,
            "tasks": list(plan.shard.heads) if plan.task_parallel
            else None}


def _spec_lm(torch, spec, device, mesh=None, case="lm_spec"):
    """A ``SPEC_CASES`` case of phase train_dist: ``lm`` (``lm-mtl`` where
    the config has per-source heads) on a plan whose ``spec_fn`` (the
    trunk's ``shared_spec_fn``) cuts its leaves over ``mesh``,
    ``spec["steps"]`` steps of ``DIST_LM`` rows (one a data rank; a task's
    rows for lm-mtl) from a seeded generator. (f) ``lm_spec``:
    qwen1.5-0.5b at full width, ``fsdp=True``, computed tensor-parallel
    (16 heads and the vocab over ``model``, FSDP over ``data``); (h)
    ``moe_tp``: granite-moe likewise, its 40 experts over ``model`` (20 a
    rank), its 24 / 8 heads 12 / 4 a rank; (j) ``mtl_tp``: qwen's lm-mtl,
    the trunk as (f) and its ``MTL_TP_TASKS`` heads over ``model``
    (``"par"``); (d') ``dp_spec``: xlstm-125m, whose family keeps the
    data-parallel step. ``mesh`` None is the one process the ranks are
    held to. Returns the losses (and lm-mtl's per-task losses), the sum
    of AdamW's v (each block and head once), each step's host seconds
    and, on a rank, the fingerprint of each block it holds after every
    step, the whole-tree gathers its steps made (``ShardingPlan.gather``),
    the bytes it holds beside its blocks' count (and its heads') and what
    it computes (``_tp_layout``)."""
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.core.taskpar import MTPConfig, take_heads
    from repro_torch.launch.memory import param_bytes_per_device as nbytes
    from repro_torch.engine import (ShardingPlan, TrainState, build_model,
                                    make_step)
    from repro_torch.optim import adamw
    arch, fsdp, _ = SPEC_CASES[case]
    cfg = spec[arch].replace(fsdp=fsdp)
    B, S = spec["lm"]
    T = cfg.n_tasks
    mtl = T > 1
    dev = torch.device(device)
    model = build_model("lm-mtl" if mtl else "lm", cfg)
    opt = adamw(3e-4, weight_decay=0.01, grad_clip=1.0)
    plan = None
    if mesh is not None:
        fn = make_spec_fn(cfg, mesh)
        plan = ShardingPlan(mesh=mesh, mtp=MTPConfig(T, "par"),
                            shared_spec_fn=fn) if mtl else \
            ShardingPlan(mesh=mesh, spec_fn=fn)
    full = model.init(0, device=dev)
    layout = {} if plan is None else plan.layout(full)
    params = full if plan is None else plan.shard_params(full)
    out = {}
    if plan is not None:
        specs = {p: s for p, (_, s) in layout.items()}
        blocks = nbytes(full, specs=specs, mesh=mesh) if not mtl else (
            nbytes(full["shared"], mesh=mesh, specs={
                p[len("shared/"):]: s for p, s in specs.items()})
            + nbytes(take_heads(full["heads"], plan.shard.heads)))
        out["held_bytes"] = 3 * nbytes(params)
        out["blocks_bytes"] = 3 * blocks
        out["cut_leaves"] = len(layout)
        out["tp"] = _tp_layout(cfg, plan, layout)
    del full
    state = TrainState.create(params, opt)
    step = make_step(model, opt, plan)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    losses, per_task, prints, step_s = [], [], [], []
    with _whole_gathers() as whole:
        for _ in range(spec["steps"]):
            shape = (2, T, B, S) if mtl else (2, B, S)
            toks = torch.randint(0, cfg.vocab, shape, generator=g,
                                 device=dev).to(torch.int32)
            batch = {"tokens": toks[0], "labels": toks[1]}
            if plan is not None:
                batch = plan.shard_batch(batch, device=dev)
            _sync(torch, dev)
            t0 = time.perf_counter()
            state, o = step(state, batch)
            losses.append(float(o.loss))
            step_s.append(time.perf_counter() - t0)
            if mtl:
                per_task.append(o.metrics["per_task_loss"])
            if plan is not None:
                prints.append(_block_prints(torch, state.params, plan,
                                            layout))
    out.update(losses=losses,
               per_task=torch.stack(per_task).tolist() if mtl else None,
               fingerprints=prints, step_s=step_s, whole_gathers=len(whole),
               v_sum=_v_sum_blocks(torch, state.opt_state.v, plan, layout))
    return out


@contextlib.contextmanager
def _whole_gathers():
    """A list that receives one entry for every ``ShardingPlan.gather``
    (every cut leaf gathered whole) made while the block runs."""
    from repro_torch.engine import ShardingPlan
    calls, real = [], ShardingPlan.gather

    def counted(self, tree, layout):
        calls.append(len(layout))
        return real(self, tree, layout)
    ShardingPlan.gather = counted
    try:
        yield calls
    finally:
        ShardingPlan.gather = real


def _block_prints(torch, params, plan, layout) -> dict:
    """``{path: (the block this rank holds, its fingerprint)}``: two
    ranks that hold the same block of a leaf (or the whole leaf) must
    hold the same bits."""
    from repro_torch import interop
    from repro_torch.configs.sharding import rank_slices
    flat = interop.leaves(params)
    keys = {p: str(rank_slices(*layout[p], plan.mesh, plan.coords))
            if p in layout else f"heads {plan.shard.heads}"
            if p.startswith("heads/") else "whole" for p in flat}
    return dict(zip(sorted(flat), zip(
        (keys[p] for p in sorted(flat)),
        map(tuple, _fingerprint(torch, params)))))


def _v_sum_blocks(torch, v, plan, layout) -> float:
    """The sum of AdamW's v over the whole tree, each block once: a
    rank adds the blocks it is the first holder of (a whole leaf: rank
    0; per-source heads: the first rank of each head group) and one SUM
    over the ranks adds them (None: one process)."""
    from repro_torch import interop
    from repro_torch.configs.sharding import holds_first_copy
    flat = interop.leaves(v)
    if plan is None:
        return float(sum(x.double().sum() for x in flat.values()))
    import torch.distributed as dist
    first = all(i == 0 for i in plan.coords.values())
    mine = [x for p, x in flat.items() if (
        holds_first_copy(layout[p][1], plan.mesh, plan.coords)
        if p in layout else plan.shard.index == 0
        if p.startswith("heads/") else first)]
    total = torch.tensor([float(sum(x.double().sum() for x in mine))],
                         dtype=torch.float64)
    dist.all_reduce(total)
    return float(total[0])


@contextlib.contextmanager
def _routes():
    """A list that receives, for every MoE routing made while the block
    runs (``models.moe.route``), each token's chosen experts and its top
    k + 1 router probabilities (device tensors; numpy after the block)."""
    from repro_torch.models import moe
    real, rec = moe.route, []

    def recorded(params, xf, cfg):
        probs, gate, choice = real(params, xf, cfg)
        rec.append((choice, probs.topk(cfg.top_k + 1, dim=-1).values))
        return probs, gate, choice
    moe.route = recorded
    try:
        yield rec
    finally:
        moe.route = real
    rec[:] = [(c.cpu().numpy(), t.float().cpu().numpy()) for c, t in rec]


def _tp_serve(torch, spec, device, mesh=None, case="tp_serve"):
    """A ``SERVE_CASES`` case of phase train_dist, served by
    ``greedy_generate(impl="pallas")``: the prefill of the ``DIST_LM``
    rows and ``DIST_TP_NEW`` greedy tokens. On ``mesh`` each rank serves
    its data rank's rows tensor-parallel from its blocks, its vocab
    block's argmax. (g) ``tp_serve``: qwen1.5-0.5b (f32 compute), #5 and
    #6 on its 8 heads, with ``fsdp=True`` as ``lm_spec``: the prefill and
    every decode step gather each layer's FSDP leaves over ``data``
    (``gather_unit`` under no_grad) and the outer leaves once a pass
    (``outer_units``); (i) ``mla_serve``: deepseek-v2 (bf16 as
    configured, ``fsdp=False``), #5 at q/k head dim 192 on its 64 of 128
    heads after the replicated latent, the absorbed decode on them, its
    80 of 160 experts; (k) ``xattn_serve``: seamless-m4t-medium (f32),
    ``XATTN_FRAMES`` seeded source frames a row encoded first
    (``make_encode_step``: #5 on the rank's 8 of 16 heads an encoder
    layer), then served with that memory (#5 on 8 heads for each decoder
    layer's self- and cross-attention in the prefill and its one-query
    cross-attention a decode step, #6 for its self-attention a decode
    step). ``mesh`` None is the one process it is held to. Returns the
    tokens, the logits each was taken from (the whole vocab, gathered
    over ``model``), an enc-dec row's memory, the host seconds of the
    encoding, the prefill and the decode steps and, for a MoE, every
    routing's choices and top router probabilities (``_routes``:
    ``_tp_serve_check``'s near-tie rule)."""
    from repro_torch.configs.sharding import make_spec_fn
    from repro_torch.engine import ShardingPlan, build_model
    from repro_torch.models.frontends import AUDIO_EMBED_DIM
    from repro_torch.train.serve import greedy_generate, make_encode_step
    arch, fsdp = SERVE_CASES[case]
    cfg = spec[arch].replace(fsdp=fsdp)
    B, S = spec["lm"]
    dev = torch.device(device)
    params = build_model("lm", cfg).init(0, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rows = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                    device=dev).to(torch.int32)}
    if cfg.n_enc_layers:
        rows["src"] = torch.randn((B, spec["frames"], AUDIO_EMBED_DIM),
                                  generator=g, device=dev)
    plan, out = None, {}
    if mesh is not None:
        plan = ShardingPlan(mesh=mesh, spec_fn=make_spec_fn(cfg, mesh))
        layout = plan.layout(params)
        params = plan.shard_params(params)
        out["tp"] = _tp_layout(cfg, plan, layout)
        rows = plan.slice_batch(rows)
    timings, memory = {}, None
    if cfg.n_enc_layers:
        _sync(torch, dev)
        t0 = time.perf_counter()
        memory = make_encode_step(cfg, "pallas", plan)(params, rows["src"])
        _sync(torch, dev)
        timings["encode_s"] = time.perf_counter() - t0
        out["memory"] = memory.float().cpu().numpy()
    with _routes() as routes:
        toks, logits = greedy_generate(params, cfg, rows["tokens"],
                                       DIST_TP_NEW, impl="pallas",
                                       device=dev, return_logits=True,
                                       timings=timings, plan=plan,
                                       memory=memory)
    # numpy, not a tensor: a rank's tensor crosses the result queue as a
    # shared-memory handle that dies with the rank's process
    return {"tokens": toks.cpu().tolist(),
            "logits": logits.float().cpu().numpy(),
            "rows": None if plan is None else plan.shard.index, **timings,
            "routes": routes, **out}


def _tp_rank(rank, world, spec, device):
    """One rank of phase train_dist's tensor-parallel job on a
    ``DIST_SPEC_MESH`` mesh: (f) ``lm_spec``, (g) ``tp_serve``, (h)
    ``moe_tp``, (i) ``mla_serve``, (j) ``mtl_tp``, then (k)
    ``xattn_serve``, each with the launch counts zeroed just before it
    and the peak reset."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    entered = time.monotonic()
    dev = rank_device()
    counters = {"segment_sum_2d": ss_ops.segment_sum.two_d,
                "flash_attention": fa_ops.flash_attention,
                "flash_decode": fd_ops.flash_decode}
    real = _timed_all_reduce(dist, torch, dev)
    mesh = make_host_mesh(*DIST_SPEC_MESH)
    out = {"rank": rank, "t_enter": entered, "t_import": _IMPORTED,
           "cases": {}}
    try:
        out["cases"]["lm_spec"] = _case_run(torch, dev, counters, _spec_lm,
                                            torch, spec, device, mesh)
        out["cases"]["tp_serve"] = _case_run(torch, dev, counters, _tp_serve,
                                             torch, spec, device, mesh)
        out["cases"]["moe_tp"] = _case_run(torch, dev, counters, _spec_lm,
                                           torch, spec, device, mesh,
                                           case="moe_tp")
        out["cases"]["mla_serve"] = _case_run(
            torch, dev, counters, _tp_serve, torch, spec, device, mesh,
            case="mla_serve")
        out["cases"]["mtl_tp"] = _case_run(torch, dev, counters, _spec_lm,
                                           torch, spec, device, mesh,
                                           case="mtl_tp")
        out["cases"]["xattn_serve"] = _case_run(
            torch, dev, counters, _tp_serve, torch, spec, device, mesh,
            case="xattn_serve")
    finally:
        dist.all_reduce = real
    out["t_exit"] = time.monotonic()
    return out


def _dist_spec():
    """What the phase trains and serves, passed whole to the ranks (their
    module is this file imported anew): full width; granite-moe, xlstm and
    deepseek-v2 cut in depth. The LMs it trains compute in f32: in bf16
    each rank rounds its partial gradient sums to bf16 where one process
    rounds the whole sum once, and a router's top-k flips where two logits
    lie within a bf16 rounding, so only f32 compute holds the ranks to the
    one-process session within repro's cross-plan tolerance. deepseek-v2
    is only served (``mla_serve``), bf16 as configured, held to one
    process by the near-tie rule (``_tp_serve_check``); qwen's lm-mtl
    (``mtl_tp``) and seamless (``xattn_serve``) are cut in depth to
    ``MTL_TP_LAYERS`` and ``XATTN_LAYERS``, never in width."""
    import torch
    from repro_torch.configs import (deepseek_v2_236b, granite_moe_3b_a800m,
                                     hydragnn_gfm, qwen1_5_0_5b,
                                     seamless_m4t_medium, xlstm_125m)
    f32 = {"compute_dtype": torch.float32}
    enc, dec = XATTN_LAYERS
    return {"gfm": hydragnn_gfm.CONFIG.replace(segment_sum_impl="fused"),
            "qwen": qwen1_5_0_5b.CONFIG.replace(**f32),
            "qwen_mtl": qwen1_5_0_5b.CONFIG.replace(
                n_layers=MTL_TP_LAYERS, n_tasks=MTL_TP_TASKS, **f32),
            "seamless": seamless_m4t_medium.CONFIG.replace(
                n_enc_layers=enc, n_layers=dec, **f32),
            "frames": XATTN_FRAMES,
            "moe": granite_moe_3b_a800m.CONFIG.replace(
                n_layers=DIST_MOE_LAYERS, **f32),
            "xlstm": xlstm_125m.CONFIG.replace(n_layers=REC_XLSTM_LAYERS,
                                               **f32),
            "deepseek": deepseek_v2_236b.CONFIG.replace(
                n_layers=DEEPSEEK_LAYERS[1]),
            "lm": DIST_LM, "steps": DIST_STEPS,
            "soak_steps": DIST_SOAK_STEPS, "world": DIST_WORLD,
            "soak_dir": str(ROOT / "build" / "chip_smoke" / "dist_soak")}


def _dist_session(spec, case, device, mesh=None, resilience=None):
    """The ``Session`` of one case of phase train_dist: ``mesh`` None is
    the one-process session the ranks are held to. (a) ``finetune``: a
    fresh branch on a seeded trunk (``examples/finetune_downstream_
    torch.py``'s model), one transition1x source, 8 graphs a step; (b)
    ``lm`` / ``lm_accum2``: qwen, ``DIST_LM`` rows a rank at accum 1 and
    2; (c) ``lm_mtl``: qwen's two task heads on the ``"base"`` plan, one
    row a task a rank; (d) ``moe``: granite-moe ``lm``; (e) ``soak``:
    GFM-MTL on three sources x 8 graphs, ``"base"``."""
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.data.synthetic_atoms import (generate_all,
                                                  generate_source,
                                                  source_dicts)
    from repro_torch.engine import Session, SessionConfig
    B, S = spec["lm"]
    n = spec["world"]
    kw = dict(steps=spec["steps"], lr=3e-4, log_every=1,
              eval_every=10 ** 9, seed=0, verbose=False)
    model = None
    if case == "finetune":
        from repro_torch.models import gnn
        cfg = spec["gfm"]
        model = _example("finetune_downstream_torch").finetune_model(
            cfg, gnn.egnn_init(cfg, seed=7, device=device))
        sources = source_dicts({"transition1x": generate_source(
            "transition1x", 16, max_atoms=cfg.max_atoms,
            max_edges=cfg.max_edges, seed=99)})[0]
        kw.update(model="gfm-finetune", batch_per_task=8, lr=FT_LR)
    elif case == "soak":
        cfg = spec["gfm"]
        sources = source_dicts(generate_all(
            16, max_atoms=cfg.max_atoms, max_edges=cfg.max_edges,
            sources=list(FT_SOURCES)))
        kw.update(model="gfm-mtl", batch_per_task=8, lr=1e-3, warmup=2,
                  steps=spec["soak_steps"], mode="base",
                  resilience=resilience)
    elif case == "lm_mtl":
        cfg = spec["qwen"].replace(n_tasks=2)
        sources = make_lm_sources(2, 8, S, cfg.vocab)
        kw.update(model="lm-mtl", batch_per_task=n, mode="base")
    else:
        cfg = spec["moe" if case == "moe" else "qwen"]
        sources = make_lm_sources(1, 16, S, cfg.vocab)[0]
        kw.update(model="lm", batch_per_task=B * n,
                  accum=2 if case == "lm_accum2" else 1)
    return Session(SessionConfig(arch=cfg, **kw), sources=sources,
                   mesh=mesh, model=model, device=device)


def _fingerprint(torch, tree) -> list:
    """Two 64-bit sums of each leaf's bit patterns, plain and squared (on
    the device, wrapping): any one element that differs changes the
    first. The ranks' params after every step are compared by it."""
    from repro_torch import interop
    out = []
    for _, v in sorted(interop.leaves(tree).items()):
        b = v.detach().reshape(-1).view(
            torch.int32 if v.element_size() == 4 else torch.int16).long()
        out.append(torch.stack([b.sum(), (b * b).sum()]))
    return torch.stack(out).cpu().tolist()


def _dist_run(torch, sess, counters, dev):
    """Run ``sess`` with the launch counts and the all-reduce clock zeroed
    just before; the fingerprint of the full params after every step."""
    prints, inner = [], sess.step_fn

    def traced(state, batch):
        state, out = inner(state, batch)
        prints.append({"params": ("whole", _fingerprint(
            torch, sess.plan.gather_params(state.params)))})
        return state, out
    sess.step_fn = traced
    _sync(torch, dev)
    for c in counters.values():
        c.launches = 0
    _ALLREDUCE[0] = 0.0
    t0 = time.perf_counter()
    with sess:
        res = sess.run()
    _sync(torch, dev)
    return res, {"v_sum": _v_sum(sess, res.state),
                 "launches": {k: c.launches for k, c in counters.items()},
                 "wall_s": time.perf_counter() - t0,
                 "allreduce_s": _ALLREDUCE[0], "fingerprints": prints}


def _v_sum(sess, state) -> float:
    """The sum of AdamW's second moments over every parameter (a
    collective on a task-parallel plan): AdamW's update hides a gradient
    off by a constant factor from the losses, not from this sum."""
    from repro_torch import interop
    v = sess.plan.gather_params(state.opt_state.v)
    return float(sum(x.double().sum() for x in interop.leaves(v).values()))


_ALLREDUCE = [0.0]                  # a rank's seconds in dist.all_reduce


def _timed_all_reduce(dist, torch, dev):
    """Wrap ``dist.all_reduce`` (every collective sum of the port goes
    through it) to add its host-clock seconds, the device synchronized on
    both sides, to ``_ALLREDUCE``."""
    real = dist.all_reduce

    def timed(tensor, *a, **kw):
        _sync(torch, dev)
        t0 = time.perf_counter()
        r = real(tensor, *a, **kw)
        _sync(torch, dev)
        _ALLREDUCE[0] += time.perf_counter() - t0
        return r
    dist.all_reduce = timed
    return real


def _dist_soak(torch, spec, device, mesh, counters, dev):
    """(e): the soak under the five fault classes, its ``resume()`` to the
    end, and a clean run, on every rank of the ``"base"`` plan."""
    from repro_torch import interop
    from repro_torch.resilience import (CheckpointPolicy, FaultSchedule,
                                        GuardConfig, ResilienceConfig)

    def res(d, faults=None):
        return ResilienceConfig(
            ckpt_dir=os.path.join(spec["soak_dir"], d), faults=faults,
            retry_base_delay=0.0, guard=GuardConfig(
                warmup_steps=2, spike_factor=50.0, max_consecutive_trips=1),
            policy=CheckpointPolicy(every_steps=4, keep_last=2),
            max_ticks=4 * spec["soak_steps"])
    out = {}
    for name, d, faults, resume in (
            ("faulted", "f", FaultSchedule.from_dict(SOAK_FAULTS), False),
            ("resumed", "f", None, True), ("clean", "c", None, False)):
        sess = _dist_session(spec, "soak", device, mesh,
                             resilience=res(d, faults))
        if resume:
            out["resumed_at"] = sess.resume()
        result, run = _dist_run(torch, sess, counters, dev)
        st, rep = result.state, result.resilience
        run.update(
            step=int(st.step), opt_step=int(st.opt_state.step),
            guard=[float(st.guard.ema), int(st.guard.good),
                   int(st.guard.trips)],
            state_sha=_sha(v for t in (st.params, st.opt_state.m,
                                       st.opt_state.v)
                           for _, v in sorted(interop.leaves(t).items())),
            losses=[r["loss"] for r in result.logger.history],
            per_task=_per_task(result, 3), preempted=result.preempted,
            events=[(e["kind"], e["tick"]) for e in rep["events"]],
            report={k: rep[k] for k in (
                "ticks", "steps", "checkpoints_saved", "io_retries",
                "pipeline_recoveries", "faults_fired", "faults_pending",
                "trips", "rollbacks", "save_ms")},
            listing=sorted(os.listdir(os.path.join(spec["soak_dir"], d))))
        out[name] = run
        del sess, result, st
        _rank_free(torch, dev)
    return out


def _case_run(torch, dev, counters, fn, *args, **kw) -> dict:
    """``fn(*args, **kw)``'s result dict with the launch counts and the
    all-reduce clock zeroed and the peak reset just before; adds the
    launches, the all-reduce seconds and the peak, then frees the rank."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    _ALLREDUCE[0] = 0.0
    run = fn(*args, **kw)
    run.update(launches={k: c.launches for k, c in counters.items()},
               allreduce_s=_ALLREDUCE[0],
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else None)
    _rank_free(torch, dev)
    return run


def _rank_free(torch, dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def _dist_rank(rank, world, spec, device):
    """One rank of phase train_dist: cases (a)-(d) on a (world, 1) mesh,
    (d') ``dp_spec`` on a ``DIST_DP_SPEC_MESH`` mesh, then the soak (e);
    per case the losses, the launch counts from zero, the params'
    fingerprint after every step, the sum of AdamW's v, the seconds in
    gloo's all-reduce, and the peak."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops
    from repro_torch.launch.mesh import make_host_mesh, rank_device
    entered = time.monotonic()
    dev = rank_device()
    counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
                "segment_sum": ss_ops.segment_sum,
                "segment_sum_2d": ss_ops.segment_sum.two_d}
    real = _timed_all_reduce(dist, torch, dev)
    mesh = make_host_mesh(world, 1)
    out = {"rank": rank, "t_enter": entered, "t_import": _IMPORTED,
           "cases": {}}

    def session_case(case):
        sess = _dist_session(spec, case, device, mesh)
        heads = list(sess.plan.shard.heads)
        result, run = _dist_run(torch, sess, counters, dev)
        return dict(run, losses=[r["loss"] for r in result.logger.history],
                    per_task=_per_task(result, 2)
                    if case == "lm_mtl" else None, heads=heads)
    try:
        for case in DIST_CASES:
            out["cases"][case] = _case_run(torch, dev, counters,
                                           session_case, case)
        out["cases"]["dp_spec"] = _case_run(
            torch, dev, counters, _spec_lm, torch, spec, device,
            make_host_mesh(*DIST_DP_SPEC_MESH), case="dp_spec")
        out["soak"] = _dist_soak(torch, spec, device, mesh, counters, dev)
    finally:
        dist.all_reduce = real
    out["t_exit"] = time.monotonic()
    return out


def _dist_launches(spec, case, device, soak=None) -> dict:
    """The launches a rank's run of ``case`` implies: the trunk once a
    microbatch (a GNN layer: #3 and #4 once each), one embedding backward
    (#1) a microbatch; none off the card (the plain versions run there).
    The soak steps on every tick but a recovery's and the preemption's."""
    zero = {"egnn_edge": 0, "egnn_edge_bwd": 0, "segment_sum": 0,
            "segment_sum_2d": 0}
    if device != "cuda":
        return zero
    if case == "soak":
        rep = soak["report"]
        steps = rep["ticks"] - rep["pipeline_recoveries"] - \
            int(soak["preempted"])
    else:
        steps = spec["steps"] * (2 if case == "lm_accum2" else 1)
    layers = spec["gfm"].gnn_layers if case in ("finetune", "soak") else 0
    return dict(zero, egnn_edge=layers * steps, egnn_edge_bwd=layers * steps,
                segment_sum_2d=steps)


def train_dist_phase(torch, device=DEVICE, spec=None):
    """Phase train_dist (see the module docstring)."""
    spec = spec or _dist_spec()
    n = spec["world"]
    out = {"phase": "train_dist", "backend": "gloo", "world": n,
           "steps": spec["steps"], "lm_rows_a_rank": list(spec["lm"]),
           "moe_layers": spec["moe"].n_layers,
           "tolerance": {"rtol": MTP_RTOL, "atol": MTP_ATOL,
                         "params_across_ranks": "bitwise (each leaf's "
                         "fingerprint after every step)",
                         "soak_vs_clean": "bitwise",
                         "v_sum_rel": DIST_V_TOL},
           "note": "two ranks time-share one card over gloo: the times are "
                   "not a scaling result, and NCCL is not exercised",
           "cases": {}}
    # the one-process sessions the ranks are held to, freed before the
    # spawn; the soak's clean run against the first steps of one process
    t0 = time.perf_counter()
    refs = {}
    for case in DIST_CASES + ("soak",):
        sess = _dist_session(dict(spec, soak_steps=spec["steps"]), case,
                             device)
        with sess:
            res = sess.run()
        refs[case] = {"losses": [r["loss"] for r in res.logger.history],
                      "per_task": _per_task(res, len(sess.task_names))
                      if case in ("lm_mtl", "soak") else None,
                      "v_sum": _v_sum(sess, res.state)}
        del sess, res
        if device == "cuda":
            _free(torch)
    for case in SPEC_CASES:
        refs[case] = _spec_lm(torch, spec, device, case=case)
        if device == "cuda":
            _free(torch)
    for case in SERVE_CASES:
        refs[case] = _tp_serve(torch, spec, device, case=case)
        if device == "cuda":
            _free(torch)
    out["reference_s"] = time.perf_counter() - t0
    shutil.rmtree(spec["soak_dir"], ignore_errors=True)
    ranks, job = _dist_job(_dist_rank, (n, 1), spec, device, "train_dist job")
    out.update(job)
    tp_ranks, out["tp_job"] = _dist_job(_tp_rank, DIST_SPEC_MESH, spec,
                                        device,
                                        "train_dist tensor-parallel job")
    launches = {"egnn_edge": 0, "egnn_edge_bwd": 0, "segment_sum": 0,
                "segment_sum_2d": 0, "flash_attention": 0, "flash_decode": 0}
    off = []          # every case is checked and shown before a failure
    for case in DIST_CASES:
        name, ref = f"train_dist {case}", refs[case]
        runs = [r["cases"][case] for r in ranks]
        worst = max(_close_rows([r["losses"]], [ref["losses"]])
                    for r in runs)
        row = {"loss_err_vs_tol": worst, "losses": runs[0]["losses"],
               "reference": ref["losses"]}
        if ref["per_task"] is not None:
            worst_t = max(_close_rows(r["per_task"], ref["per_task"])
                          for r in runs)
            worst = max(worst, worst_t)
            row.update(per_task_err_vs_tol=worst_t,
                       per_task=runs[0]["per_task"],
                       reference_per_task=ref["per_task"])
        v_err = max(abs(r["v_sum"] - ref["v_sum"]) for r in runs) / \
            abs(ref["v_sum"])
        row["v_sum_rel_err"] = v_err
        print(f"chip_smoke: {name}: {json.dumps(row)}", file=sys.stderr,
              flush=True)
        if not worst <= 1.0:
            off.append(f"{name}: losses off the one-process session's by "
                       f"{worst} x the tolerance")
        if not v_err <= DIST_V_TOL:
            off.append(f"{name}: AdamW's second moments sum to {v_err} "
                       "(relative) off the one-process session's")
        _blocks_agree(name, runs, spec["steps"])
        want = _dist_launches(spec, case, device)
        _launches_as_designed(name, runs, want, launches)
        row.update(launches_per_rank=want, ranks=[
            {"wall_s": r["wall_s"], "peak_mem_bytes": r["peak_mem_bytes"],
             "allreduce_ms_per_step": r["allreduce_s"] * 1e3
             / spec["steps"], "heads": r["heads"]} for r in runs])
        out["cases"][case] = row
    for case, job in (("dp_spec", ranks), ("lm_spec", tp_ranks),
                      ("moe_tp", tp_ranks), ("mtl_tp", tp_ranks)):
        out["cases"][case] = row = _spec_check(spec, case, job, refs,
                                               device, off, launches)
        print(f"chip_smoke: train_dist {case}: {json.dumps(row)}",
              file=sys.stderr, flush=True)
    for case in SERVE_CASES:
        out["cases"][case] = row = _tp_serve_check(
            spec, case, tp_ranks, refs, device, off, launches)
        print(f"chip_smoke: train_dist {case}: {json.dumps(row)}",
              file=sys.stderr, flush=True)
    if off:
        fail("; ".join(off))
    out["soak"] = _dist_soak_check(spec, ranks, refs["soak"], device,
                                   launches)
    out["launches"] = launches
    shutil.rmtree(spec["soak_dir"], ignore_errors=True)
    return out


def _dist_job(fn, mesh, spec, device, label):
    """``fn(rank, world, spec, device)`` on the ranks of a ``mesh`` =
    (data, model) job of phase train_dist (the 2-rank job's ranks make
    their own meshes too). Returns the ranks' results and the job's wall,
    import, startup, ranks and teardown seconds."""
    from repro_torch.launch.mesh import run_ranks
    world = mesh[0] * mesh[1]
    rdzv = ROOT / "build" / "chip_smoke"
    rdzv.mkdir(parents=True, exist_ok=True)
    t0, spawned = time.perf_counter(), time.monotonic()
    try:
        ranks = run_ranks(fn, world, backend="gloo", device=device,
                          args=(spec, device), timeout=DIST_TIMEOUT_S,
                          rdzv_dir=str(rdzv))
    except Exception as e:                        # noqa: BLE001
        fail(f"{label}: {e}")
    entered = max(r["t_enter"] for r in ranks)
    job = {"world": world, "mesh": list(mesh),
           "wall_s": time.perf_counter() - t0,
           "import_s": max(r["t_import"] for r in ranks) - spawned,
           "startup_s": entered - spawned,
           "ranks_s": max(r["t_exit"] for r in ranks) - entered,
           "teardown_s": time.monotonic() - max(r["t_exit"] for r in ranks)}
    print(f"chip_smoke: {label}: " + json.dumps(job), file=sys.stderr,
          flush=True)
    return ranks, job


def _spec_launches(spec, case, device) -> dict:
    """The launches a rank's run of a ``SPEC_CASES`` or ``SERVE_CASES``
    case implies: one embedding backward (#1; (f), (h) and (j) over the
    rank's vocab block) a step; (g) #5 once a layer in the prefill and #6
    once a layer a decode step (on the rank's 8 of 16 heads); (i) #5 once
    a layer in the prefill (at head dim 192 on its 64 heads) and no #6
    (MLA decodes absorbed, by plain products); (k) #5 once an encoder
    layer, twice a decoder layer in the prefill (self and cross) and
    once a decoder layer a decode step (the one-query cross-attention),
    #6 once a decoder layer a decode step; none off the card."""
    if case == "dp_spec":           # the 2-rank job's counters, as (b)
        return _dist_launches(spec, "lm", device)
    zero = {"segment_sum_2d": 0, "flash_attention": 0, "flash_decode": 0}
    if device != "cuda":
        return zero
    if case in SPEC_CASES:
        return dict(zero, segment_sum_2d=spec["steps"])
    cfg = spec[SERVE_CASES[case][0]]
    L, steps = cfg.n_layers, DIST_TP_NEW - 1
    if cfg.n_enc_layers:       # the encoder; self and cross a prefill;
        return dict(zero,      # cross (#5) and self (#6) a decode step
                    flash_attention=cfg.n_enc_layers + 2 * L + L * steps,
                    flash_decode=L * steps)
    decode = 0 if case == "mla_serve" else L * steps
    return dict(zero, flash_attention=L, flash_decode=decode)


def _launches_as_designed(name, runs, want, launches):
    """Each rank's launches equal to the design's ``want``; added to the
    phase's ``launches``."""
    for i, r in enumerate(runs):
        if r["launches"] != want:
            fail(f"{name} rank {i}: launches {r['launches']}, the design "
                 f"implies {want}")
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v


def _spec_check(spec, case, ranks, refs, device, off, launches) -> dict:
    """A ``SPEC_CASES`` case: the ranks' losses and v against one process,
    each block equal on the ranks that hold it after every step, a rank's
    bytes equal to its blocks', one embedding backward (#1) a step on the
    card."""
    name, ref = f"train_dist {case}", refs[case]
    runs = [r["cases"][case] for r in ranks]
    worst = max(_close_rows([r["losses"]], [ref["losses"]]) for r in runs)
    if ref["per_task"] is not None:
        worst = max([worst] + [_close_rows(r["per_task"], ref["per_task"])
                               for r in runs])
    v_err = max(abs(r["v_sum"] - ref["v_sum"]) for r in runs) / \
        abs(ref["v_sum"])
    if not worst <= 1.0:
        off.append(f"{name}: losses off the one-process step's by {worst} "
                   "x the tolerance")
    if case != "dp_spec" and any(r["whole_gathers"] for r in runs):
        off.append(f"{name}: a tensor-parallel step gathered a cut leaf "
                   f"whole ({[r['whole_gathers'] for r in runs]} calls)")
    if not v_err <= DIST_V_TOL:
        off.append(f"{name}: AdamW's second moments sum to {v_err} "
                   "(relative) off the one-process step's")
    _blocks_agree(name, runs, spec["steps"])
    for i, r in enumerate(runs):
        if r["held_bytes"] != r["blocks_bytes"]:
            fail(f"{name} rank {i}: holds {r['held_bytes']} B, its blocks "
                 f"are {r['blocks_bytes']} B")
    want = _spec_launches(spec, case, device)
    _launches_as_designed(name, runs, want, launches)
    arch, fsdp, mesh = SPEC_CASES[case]
    return {"arch": spec[arch].name, "layers": spec[arch].n_layers,
            "tasks": spec[arch].n_tasks, "mesh": list(mesh), "fsdp": fsdp,
            "loss_err_vs_tol": worst, "losses": runs[0]["losses"],
            "reference": ref["losses"], "per_task": runs[0]["per_task"],
            "reference_per_task": ref["per_task"], "v_sum_rel_err": v_err,
            "whole_gathers": [r["whole_gathers"] for r in runs],
            "cut_leaves": runs[0]["cut_leaves"],
            "tp": [r["tp"] for r in runs],
            "held_bytes": [r["held_bytes"] for r in runs],
            "step_s": [r["step_s"] for r in runs],
            "reference_step_s": ref["step_s"], "launches_per_rank": want,
            "peak_mem_bytes": [r["peak_mem_bytes"] for r in runs],
            "allreduce_s": [r["allreduce_s"] for r in runs]}


def _row_routing(routes, call, row, S, cfg):
    """Row ``row``'s tokens in MoE routing ``call`` (``_routes``' record;
    ``S`` tokens a row in that call): their experts (n, k), their top k
    + 1 router probabilities and which choices their groups' capacity
    kept (``models.moe``'s token-major queue)."""
    import numpy as np

    from repro_torch.models.moe import _capacity
    choice, top = routes[call]
    G, gs, k = choice.shape
    C = _capacity(gs, k, cfg.n_experts, cfg.capacity_factor)
    keep = np.zeros(choice.shape, bool)
    for g in range(G):
        seen = {}
        for i in range(gs):
            for c in range(k):
                e = int(choice[g, i, c])
                keep[g, i, c] = seen.get(e, 0) < C
                seen[e] = seen.get(e, 0) + 1
    sl = slice(row * S, (row + 1) * S)
    return (choice.reshape(-1, k)[sl], top.reshape(-1, k + 1)[sl],
            keep.reshape(-1, k)[sl])


def _routing_near_tie(got, ref, rows, j, t, S, cfg) -> dict | None:
    """Whether step ``t`` of a served row routed otherwise than one
    process: None when the served position kept the same experts in
    every MoE layer (a prompt token reaches it only through the capacity
    queue at 1 layer); else the one process's relative gap (p_k -
    p_{k+1}) / p_k of every token of the row whose experts differ."""
    L = cfg.n_layers
    n = S if t == 0 else 1                 # tokens a row in the call
    gaps, same = [], True
    for call in range(t * L, (t + 1) * L):
        gc, _, gk = _row_routing(got["routes"], call, j, n, cfg)
        rc, rt, rk = _row_routing(ref["routes"], call, rows.start + j, n,
                                  cfg)
        k = cfg.top_k
        same &= set(gc[-1][gk[-1]]) == set(rc[-1][rk[-1]])
        for i in range(n):
            if set(gc[i]) != set(rc[i]):
                gaps.append(float((rt[i, k - 1] - rt[i, k]) / rt[i, k - 1]))
    return None if same else {"step": t, "router_gaps": sorted(gaps)}


def _tp_serve_check(spec, case, ranks, refs, device, off, launches) -> dict:
    """A ``SERVE_CASES`` case: each rank's greedy tokens equal to the one
    process's for its rows and the logits each was taken from within
    ``LM_TOL_F32`` ((g), (k): f32 compute) or ``LM_TOL_BF16`` x
    max|logit| ((i), bf16), (k)'s memory within ``LM_TOL_F32`` too; #5
    (and #6) as ``_spec_launches`` says on every rank. In bf16 the two
    packages' roundings differ (a rank sums its heads' and experts'
    partials over ``model``), and a token whose router's k-th and
    (k+1)-th probabilities lie within ``NEAR_TIE_REL`` of each other may
    take another expert (ROADMAP §3's near-tie rule for bf16 routing): a
    step whose served position kept other experts than one process's is
    printed with those gaps and its logits error, and accepted only where
    every gap is within ``NEAR_TIE_REL``; a row that parts from one
    process's tokens is accepted only where that step's top-two logit
    gap is within ``LM_TOL_BF16`` x max|logit| (printed); a row's later
    steps, whose contexts differ, are not compared."""
    name, ref = f"train_dist {case}", refs[case]
    runs = [r["cases"][case] for r in ranks]
    n = len(ref["tokens"]) // DIST_SPEC_MESH[0]
    bf16 = case == "mla_serve"
    cfg = spec[SERVE_CASES[case][0]]
    S = spec["lm"][1]
    atol, rtol = LM_TOL_F32
    worst, partings, near_ties = 0.0, [], []
    for i, r in enumerate(runs):
        rows = slice(r["rows"] * n, (r["rows"] + 1) * n)
        want_logits = ref["logits"][rows]
        for j, (got, want) in enumerate(zip(r["tokens"],
                                            ref["tokens"][rows])):
            part = next((t for t, (a, b) in enumerate(zip(got, want))
                         if a != b), len(want))
            for t in range(min(part + 1, len(want))):
                w = want_logits[j, t]
                d = abs(r["logits"][j, t] - w)
                if bf16:
                    err = float(d.max() / (LM_TOL_BF16 * abs(w).max()))
                else:
                    err = float((d / (atol + rtol * abs(w))).max())
                tie = _routing_near_tie(r, ref, rows, j, t, S, cfg) \
                    if cfg.n_experts else None
                if tie is None:
                    worst = max(worst, err)
                    continue
                tie.update(rank=i, row=j, logit_err_vs_tol=err)
                near_ties.append(tie)
                print(f"chip_smoke: {name} rank {i} row {j} step {t}: "
                      f"routed otherwise than one process (router gaps "
                      f"{tie['router_gaps'][:8]}, near-tie limit "
                      f"{NEAR_TIE_REL}); logits {err} x the tolerance",
                      file=sys.stderr, flush=True)
                if not (bf16 and max(tie["router_gaps"], default=1.0)
                        <= NEAR_TIE_REL):
                    off.append(f"{name} rank {i} row {j} step {t}: routed "
                               "otherwise than one process past a near-tie "
                               f"(router gaps {tie['router_gaps'][:8]})")
            if part == len(want):
                continue
            top2 = want_logits[j, part].copy()
            top2.sort()
            gap = float(top2[-1] - top2[-2])
            limit = LM_TOL_BF16 * float(abs(want_logits[j, part]).max())
            partings.append({"rank": i, "row": j, "step": part, "gap": gap,
                             "limit": limit})
            print(f"chip_smoke: {name} rank {i} row {j}: tokens part at "
                  f"step {part}; the one process's top-two gap {gap} "
                  f"(near-tie limit {limit})", file=sys.stderr, flush=True)
            if not (bf16 and gap <= limit):
                off.append(f"{name} rank {i}: tokens {got}, one process "
                           f"gave {want} (top-two gap {gap} at step "
                           f"{part})")
    if not worst <= 1.0:
        off.append(f"{name}: logits off the one process's by {worst} x "
                   "the tolerance")
    mem_err = None
    if "memory" in ref:        # each rank's rows of the encoder's memory
        mem_err = max(float((abs(r["memory"] - w) / (
            atol + rtol * abs(w))).max()) for r in runs
            for w in [ref["memory"][r["rows"] * n:(r["rows"] + 1) * n]])
        if not mem_err <= 1.0:
            off.append(f"{name}: the encoder's memory off the one "
                       f"process's by {mem_err} x the tolerance")
    want = _spec_launches(spec, case, device)
    _launches_as_designed(name, runs, want, launches)
    arch, fsdp = SERVE_CASES[case]
    return {"arch": spec[arch].name, "layers": spec[arch].n_layers,
            "mesh": list(DIST_SPEC_MESH), "fsdp": fsdp,
            "rows_a_data_rank": n, "prompt": list(spec["lm"]),
            "new": DIST_TP_NEW, "tokens": runs[0]["tokens"],
            "logit_err_vs_tol": worst, "memory_err_vs_tol": mem_err,
            "enc_layers": spec[arch].n_enc_layers,
            "encode_s": [r.get("encode_s") for r in runs],
            "reference_encode_s": ref.get("encode_s"),
            "partings": partings,
            "routing_near_ties": near_ties,
            "tp": [r["tp"] for r in runs],
            "prefill_s": [r["prefill_s"] for r in runs],
            "decode_s": [r["decode_s"] for r in runs],
            "reference_prefill_s": ref["prefill_s"],
            "reference_decode_s": ref["decode_s"], "launches_per_rank": want,
            "peak_mem_bytes": [r["peak_mem_bytes"] for r in runs],
            "allreduce_s": [r["allreduce_s"] for r in runs]}


def _blocks_agree(name, runs, steps):
    """Every block of every leaf (or the whole tree, ``"params"``) bitwise
    equal on the ranks that hold it, after every step."""
    if len(runs[0]["fingerprints"]) != steps:
        fail(f"{name}: {len(runs[0]['fingerprints'])} steps, not {steps}")
    for i in range(steps):
        for path in runs[0]["fingerprints"][i]:
            held = {}
            for r in runs:
                block, fp = r["fingerprints"][i][path]
                if held.setdefault(block, fp) != fp:
                    fail(f"{name}: {path} block {block} differs across the "
                         f"ranks that hold it after step {i}")


def _dist_soak_check(spec, ranks, ref, device, launches):
    """(e): every fault took effect on every rank alike, the resumed run
    ends bitwise equal to the clean one, every rank at the same step with
    the same events and checkpoint listing, and the clean run's first
    steps within the tolerance of one process."""
    name = "train_dist soak"
    soaks = [r["soak"] for r in ranks]
    first = soaks[0]
    for s in soaks[1:]:
        for run in ("faulted", "resumed", "clean"):
            a, b = s[run], first[run]
            if (a["step"], a["events"], a["listing"], a["state_sha"],
                    a["fingerprints"]) != (b["step"], b["events"],
                                           b["listing"], b["state_sha"],
                                           b["fingerprints"]):
                fail(f"{name} {run}: the ranks disagree on the step, the "
                     "events, the checkpoint listing or the params")
    f, r, c = first["faulted"], first["resumed"], first["clean"]
    kinds = {k for k, _ in f["events"]}
    rep = f["report"]
    if not (f["preempted"] and rep["faults_fired"] == len(SOAK_FAULTS)
            and rep["rollbacks"] >= 2 and rep["io_retries"] >= 1
            and rep["pipeline_recoveries"] == 1
            and {"rollback", "pipeline_recovery", "preempt_flush"} <= kinds):
        fail(f"{name}: the faults did not all take effect: {f['events']} "
             f"{rep}")
    if (r["step"], r["opt_step"], r["state_sha"], r["guard"]) != (
            c["step"], c["opt_step"], c["state_sha"], c["guard"]) or \
            c["step"] != spec["soak_steps"]:
        fail(f"{name}: the resumed run does not end bitwise equal to the "
             "clean 2-rank run")
    n = spec["steps"]
    worst = _close_rows(c["per_task"][:n], ref["per_task"])
    worst_total = _close_rows([c["losses"][:n]], [ref["losses"]])
    if not max(worst, worst_total) <= 1.0:
        fail(f"{name}: the clean run's first {n} steps off the one-process "
             f"session's by {max(worst, worst_total)} x the tolerance")
    for run in ("faulted", "resumed", "clean"):
        for i, rk in enumerate(ranks):
            _launches_as_designed(
                f"{name} {run} rank {i} of", [rk["soak"][run]],
                _dist_launches(spec, "soak", device, rk["soak"][run]),
                launches)
    return {"steps": spec["soak_steps"], "faults": SOAK_FAULTS,
            "events": f["events"], "report": rep,
            "resumed_at": first["resumed_at"],
            "resumed_report": r["report"], "clean_report": c["report"],
            "listing": c["listing"], "bitwise_vs_clean": True,
            "first_steps_err_vs_tol": max(worst, worst_total),
            "wall_s": {k: first[k]["wall_s"] for k in
                       ("faulted", "resumed", "clean")},
            "allreduce_ms_per_step": {
                k: first[k]["allreduce_s"] * 1e3 / max(1, len(
                    first[k]["fingerprints"])) for k in
                ("faulted", "resumed", "clean")}}


# ---------------------------------------------------------------------------
# phase 5: the LM attention kernels against their plain versions
# ---------------------------------------------------------------------------

PAD_POS = -(10 ** 9)
# the LM prefill shapes of runs (a) and (b), then edge cases
FA_CASES = [  # name, dtype, B, Sq, Sk, H, K, D, causal, window, positions
    # (positions: False = q at arange(Sk - Sq, Sk) over k at arange(Sk);
    # True = k rotated with pads every 11th; "zeros" = every position 0;
    # "distinct" = unordered draws, k pads every 7th)
    ("prefill_a", "bfloat16", 8, 1024, 1024, 32, 8, 80, True, 4096,
     False),
    ("prefill_b", "bfloat16", 1, 4200, 4200, 32, 8, 80, True, 4096,
     False),
    ("f32_prefill_a", "float32", 8, 1024, 1024, 32, 8, 80, True, 4096,
     False),
    ("f32_window_ragged", "float32", 2, 1000, 1000, 32, 8, 80, True,
     300, False),
    ("f32_no_window", "float32", 2, 333, 333, 32, 8, 80, True, 0,
     False),
    ("f32_rolled_pads", "float32", 1, 300, 300, 8, 2, 80, True, 128,
     True),
    ("bf16_rolled_pads", "bfloat16", 1, 300, 300, 8, 2, 80, True,
     128, True),
    ("f32_noncausal_mha", "float32", 1, 200, 200, 4, 4, 64, False,
     0, False),
    # the bf16 kernel's ring and skip: windows that skip tiles on both
    # sides of the diagonal, every head dim, G = 1..8, lengths ragged
    # against the 64-row query tile and the 64-key tile, rows that see no
    # key at all (Sq > Sk)
    ("bf16_window_ragged", "bfloat16", 2, 1000, 1000, 32, 8, 80, True,
     300, False),
    ("bf16_no_window", "bfloat16", 2, 333, 333, 32, 8, 80, True, 0,
     False),
    ("bf16_noncausal_mha_d64", "bfloat16", 1, 200, 200, 4, 4, 64, False,
     0, False),
    ("bf16_d16_g1_window", "bfloat16", 3, 65, 129, 4, 4, 16, True, 7,
     False),
    ("bf16_d32_g2", "bfloat16", 2, 63, 63, 8, 4, 32, True, 0, False),
    ("bf16_d96_g4", "bfloat16", 1, 129, 129, 8, 2, 96, True, 0, False),
    ("bf16_d128_g8_rows_without_keys", "bfloat16", 1, 129, 65, 8, 1, 128,
     True, 0, False),
    ("bf16_one_key", "bfloat16", 2, 1, 1, 8, 2, 80, True, 0, False),
    # the MoE family's prefill shapes: deepseek-v2's MLA (q/k head dim
    # 128 + 64, v padded to it, 128 heads) and granite-moe's G = 3
    ("mla_prefill", "bfloat16", 8, 1024, 1024, 128, 128, 192, True, 0,
     False),
    ("f32_mla_prefill", "float32", 8, 1024, 1024, 128, 128, 192, True, 0,
     False),
    ("granite_prefill", "bfloat16", 8, 1024, 1024, 24, 8, 64, True, 0,
     False),
    ("bf16_d192_window_pads", "bfloat16", 2, 300, 300, 8, 4, 192, True, 40,
     True),
    # zamba2-1.2b's shared attention block: MHA (G = 1) at D = 64, window
    # 4096, at lm_recurrent's runs (a) and (b) (the window live)
    ("zamba2_prefill", "bfloat16", 8, 1024, 1024, 32, 32, 64, True, 4096,
     False),
    ("zamba2_prefill_b", "bfloat16", 1, 4200, 4200, 32, 32, 64, True, 4096,
     False),
    # the frontends and the encoder-decoder (lm_frontends): seamless's
    # encoder (bidirectional over 4096 frames), its decoder's
    # cross-attention in prefill (1024 queries over 4096 keys, every
    # position 0) and at decode (one query), its causal self-attention;
    # internvl2's prefill (256 media + 768 text, G = 7); a cross shape
    # with distinct positions and pads, which equal positions would hide
    ("seamless_encoder", "bfloat16", 8, 4096, 4096, 16, 16, 64, False, 0,
     False),
    ("seamless_cross_prefill", "bfloat16", 8, 1024, 4096, 16, 16, 64, False,
     0, "zeros"),
    ("seamless_cross_decode", "bfloat16", 8, 1, 4096, 16, 16, 64, False, 0,
     "zeros"),
    ("seamless_self_prefill", "bfloat16", 8, 1024, 1024, 16, 16, 64, True,
     0, False),
    ("internvl2_prefill", "bfloat16", 8, 1024, 1024, 14, 2, 64, True, 0,
     False),
    ("bf16_cross_distinct_pads", "bfloat16", 2, 300, 700, 8, 4, 64, False, 0,
     "distinct"),
    ("f32_cross_distinct_pads", "float32", 2, 300, 700, 8, 4, 64, False, 0,
     "distinct"),
    ("bf16_causal_distinct_pads", "bfloat16", 2, 300, 700, 14, 2, 64, True,
     0, "distinct"),
    # lm_dense12b: gemma3-12b's prefill (16 / 8 heads of 256: each CTA
    # half the output columns), causal and with its 1024 window, at run (a)
    # and past the window at (b); stablelm-12b's (32 / 8 heads of 160);
    # each new head dim in f32 at a small shape with rolled pads
    ("gemma3_prefill", "bfloat16", 8, 1024, 1024, 16, 8, 256, True, 0,
     False),
    ("gemma3_prefill_window", "bfloat16", 8, 1024, 1024, 16, 8, 256, True,
     1024, False),
    ("gemma3_prefill_b", "bfloat16", 1, 4200, 4200, 16, 8, 256, True, 0,
     False),
    ("gemma3_prefill_b_window", "bfloat16", 1, 4200, 4200, 16, 8, 256, True,
     1024, False),
    ("stablelm_prefill", "bfloat16", 8, 1024, 1024, 32, 8, 160, True, 0,
     False),
    ("f32_d256_g2_rolled_pads", "float32", 2, 300, 300, 4, 2, 256, True, 40,
     True),
    ("f32_d160_g4_rolled_pads", "float32", 2, 300, 300, 8, 2, 160, True, 40,
     True),
]
FA_TIMED = ("prefill_a", "prefill_b", "mla_prefill", "f32_mla_prefill",
            "granite_prefill", "zamba2_prefill", "zamba2_prefill_b",
            "seamless_encoder", "seamless_cross_prefill",
            "seamless_cross_decode", "seamless_self_prefill",
            "internvl2_prefill", "gemma3_prefill", "gemma3_prefill_window",
            "gemma3_prefill_b", "gemma3_prefill_b_window",
            "stablelm_prefill")
# the LM decode shapes of runs (a) and (b), then edge cases
FD_CASES = [  # name, dtype, B, C, H, K, D, pos, window, n_splits, block_k
    ("decode_a", "bfloat16", 8, 1056, 32, 8, 80, 1040, 4096, None,
     None),
    ("decode_b_rolling", "bfloat16", 1, 4200, 32, 8, 80, 4210, 4096,
     None, None),
    ("f32_repro_plan", "float32", 3, 1000, 32, 8, 80, 700, 0, 8, 512),
    ("f32_dead_and_empty_splits", "float32", 2, 640, 8, 2, 64, 639,
     0, 12, 64),
    ("f32_rolling_window", "float32", 2, 300, 8, 8, 32, 777, 50, 5,
     None),
    # several splits a CTA (33 splits, 11 CTAs of 3); the largest
    # instantiation (f32, G = 16, D = 128)
    ("bf16_33_splits", "bfloat16", 2, 1056, 32, 8, 80, 1040, 4096, 33,
     None),
    ("f32_d128_g16", "float32", 2, 700, 16, 1, 128, 699, 0, None, None),
    # granite-moe's decode: G = 3 (24 query heads over 8 kv heads)
    ("granite_decode", "bfloat16", 8, 1056, 24, 8, 64, 1040, 0, None,
     None),
    ("f32_g3_33_splits", "float32", 2, 1056, 6, 2, 128, 1000, 0, 33,
     None),
    # zamba2-1.2b's shared attention block: G = 1, D = 64, at lm_recurrent's
    # run (a) cache and run (b)'s rolling cache under the 4096 window
    ("zamba2_decode", "bfloat16", 8, 1056, 32, 32, 64, 1040, 4096, None,
     None),
    ("zamba2_decode_b_rolling", "bfloat16", 1, 4200, 32, 32, 64, 4210, 4096,
     None, None),
    # lm_frontends: internvl2's decode, G = 7 (14 query heads over 2 kv
    # heads; cache 256 + 768 + 32), and seamless's decoder self-attention
    # (G = 1, 16 heads of 64)
    ("internvl2_decode", "bfloat16", 8, 1056, 14, 2, 64, 1040, 0, None,
     None),
    ("f32_g7_33_splits", "float32", 2, 1056, 7, 1, 128, 1000, 0, 33, None),
    ("seamless_decode", "bfloat16", 8, 1056, 16, 16, 64, 1040, 0, None,
     None),
    # lm_dense12b: gemma3-12b's decode (G = 2, D = 256: 4 consumer warps, a
    # 4-stage ring), without and with its 1024 window; stablelm-12b's (G =
    # 4, D = 160); each new head dim in f32 (D = 256: 2 consumer warps)
    ("gemma3_decode", "bfloat16", 8, 1056, 16, 8, 256, 1040, 0, None,
     None),
    ("gemma3_decode_window", "bfloat16", 8, 1056, 16, 8, 256, 1040, 1024,
     None, None),
    ("stablelm_decode", "bfloat16", 8, 1056, 32, 8, 160, 1040, 0, None,
     None),
    ("f32_d256_g2_5_splits", "float32", 2, 700, 4, 2, 256, 699, 0, 5, None),
    ("f32_d160_g4", "float32", 2, 700, 8, 2, 160, 699, 0, None, None),
]
FD_TIMED = ("decode_a", "decode_b_rolling", "granite_decode",
            "zamba2_decode", "zamba2_decode_b_rolling", "internvl2_decode",
            "seamless_decode", "gemma3_decode", "gemma3_decode_window",
            "stablelm_decode")


def _attn_err(torch, got, ref, name):
    """Max abs error of ``got`` against ``ref``, held per element to
    ATTN_TOL_F32 x max(1, max|ref|), plus ATTN_RTOL_BF16 x |ref| for bf16;
    also the worst element's share of its tolerance."""
    err, scale = scaled_err(torch, got, ref)
    diff = (got.float() - ref.float()).abs()
    tol = ATTN_TOL_F32 * scale
    if ref.dtype == torch.bfloat16:
        tol = tol + ATTN_RTOL_BF16 * ref.float().abs()
    share = float((diff / tol).max())
    if not share <= 1.0:
        fail(f"{name}: an element is off by {share:.3g} x its tolerance "
             f"(max_abs_err {err}, max|ref| {scale})")
    return err, share


def _bound(torch, n_ops, n_bytes, dtype):
    """The least time for this work: bytes over HBM, operations over the
    peak of the inputs' type (bf16 tensor cores, fp32 FFMA)."""
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops = n_ops / peak * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "operations": n_ops, "bytes": n_bytes,
            "ops_rate": "bf16 tensor cores 989 TFLOP/s"
            if dtype == torch.bfloat16 else "fp32 FFMA 67 TFLOP/s",
            "fp32_ffma_bound_ms": n_ops / FP32_FLOPS * 1e3}


def check_flash_attention(torch, dev, g):
    """#5 against ``flash_attention_ref`` (f32 scores, full softmax) at the
    LM prefill shapes and edge cases; timed at runs (a) and (b)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import keep_mask
    worst, out = 0.0, {"cases": {}}
    for name, dt, B, Sq, Sk, H, K, D, causal, window, rolled in FA_CASES:
        dt = getattr(torch, dt)

        def t(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = t(B, Sq, H, D), t(B, Sk, K, D), t(B, Sk, K, D)
        kp = torch.arange(Sk, device=dev, dtype=torch.int32)
        qp = torch.arange(Sk - Sq, Sk, device=dev, dtype=torch.int32)
        if rolled == "zeros":
            qp, kp = torch.zeros_like(qp), torch.zeros_like(kp)
        elif rolled == "distinct":
            qp = torch.randint(0, 1000, (Sq,), generator=g, device=dev,
                               dtype=torch.int32)
            kp = torch.randint(0, 1000, (Sk,), generator=g, device=dev,
                               dtype=torch.int32)
            kp[::7] = PAD_POS
        elif rolled:
            kp = torch.remainder(kp - Sk // 3, Sk)
            kp[::11] = PAD_POS
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, k, v, q_pos=qp, k_pos=kp, **kw)
        ref = flash_attention_ref(q, k, v, qp, kp, **kw)
        again = flash_attention(q, k, v, q_pos=qp, k_pos=kp, **kw)
        # lint: allow(TRC003): each case's check reads back anyway
        torch.cuda.synchronize()
        err, share = _attn_err(torch, got, ref, f"flash_attention {name}")
        if not torch.equal(got, again):
            fail(f"flash_attention {name}: two calls differ bitwise")
        worst = max(worst, err)
        out["cases"][name] = {"max_abs_err": err, "tol_share": share}
        if name not in FA_TIMED:
            continue
        keep = keep_mask(qp.long(), kp.long(), **kw)
        pairs = int(keep.sum()) * B * H

        def kernel():
            flash_attention(q, k, v, q_pos=qp, k_pos=kp, **kw)

        def plain():
            flash_attention_ref(q, k, v, qp, kp, **kw)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        # every pair kept (the encoder, cross-attention): SDPA unmasked
        lib_mask = None if bool(keep.all()) else keep

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask,
                                           enable_gqa=True)
        ms = device_ms(torch, kernel, iters=10)
        wall = time_ms(torch, kernel, iters=10)
        plain_ms = device_ms(torch, plain, iters=5)
        lib = device_ms(torch, library, iters=10)
        isz = q.element_size()
        nbytes = isz * (2 * B * Sq * H * D + 2 * B * Sk * K * D) \
            + 4 * (Sq + Sk)
        timed = {"ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
                 "library_ms": lib,
                 "library": "scaled_dot_product_attention(enable_gqa, "
                            + ("no mask)" if lib_mask is None
                               else "bool mask)"),
                 "shape": [B, Sq, Sk, H, K, D], "window": window,
                 "causal": causal,
                 "kept_pairs": pairs,
                 **_bound(torch, 4 * D * pairs, nbytes, dt)}
        if name == "prefill_a":
            out.update(timed)
        else:
            out[name] = timed
    out["max_abs_err"] = worst
    return out


def _cache_positions(torch, dev, C, pos, window):
    """k_pos of a (rolling) cache of C slots after position ``pos`` was
    written, the window folded in — what the decode path hands #6."""
    j = torch.arange(C, device=dev)
    slot_pos = pos - torch.remainder(pos - j, C)
    valid = slot_pos >= 0
    if window:
        valid &= slot_pos > pos - window
    return torch.where(valid, slot_pos, PAD_POS).to(torch.int32)


def check_flash_decode(torch, dev, g):
    """#6 against the plain split partials + combine with the same plan,
    and against ``decode_ref``, at the LM decode shapes and edge cases;
    each case's plan and kernels a call (from a profiler trace: more than
    one fails the run); timed at runs (a) and (b)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (combine_partials,
                                                  decode_partials_ref,
                                                  decode_ref, flash_decode,
                                                  plan_call)
    worst, out = 0.0, {"cases": {}}
    for name, dt, B, C, H, K, D, pos, window, n_splits, block_k in FD_CASES:
        dt = getattr(torch, dt)

        def t(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v = t(B, 1, H, D), t(B, C, K, D), t(B, C, K, D)
        kp = _cache_positions(torch, dev, C, pos, window)[None].expand(B, C)
        if name.startswith("f32_dead"):
            kp = kp.clone()
            kp[:, 128:192] = PAD_POS             # split 2: pads only
            kp[:, 320:384] = 10 ** 6             # split 5: future keys only
        qp = torch.full((B,), pos, device=dev, dtype=torch.int32)
        kw = dict(n_splits=n_splits, block_k=block_k)
        got = flash_decode(q, k, v, q_pos=qp, k_pos=kp, **kw)
        again = flash_decode(q, k, v, q_pos=qp, k_pos=kp, **kw)
        plan = plan_call(q, k, n_splits, block_k)

        def plain():
            m, l, acc = decode_partials_ref(q, k, v, q_pos=qp, k_pos=kp,
                                            n_splits=plan.n_splits,
                                            per_split=plan.per_split)
            return combine_partials(m, l, acc).reshape(B, 1, H, D).to(dt)
        ref = plain()
        oracle = decode_ref(q, k, v, q_pos=qp, k_pos=kp)
        # lint: allow(TRC003): each case's check reads back anyway
        torch.cuda.synchronize()
        err, share = _attn_err(torch, got, ref, f"flash_decode {name}")
        _attn_err(torch, got, oracle, f"flash_decode {name} vs decode_ref")
        if not torch.equal(got, again):
            fail(f"flash_decode {name}: two calls differ bitwise")
        # the profiler drops an event now and then (never adds one): a
        # count under 1 is traced again, three times at most
        for _ in range(3):
            n_kernels = device_profile(torch, lambda: flash_decode(
                q, k, v, q_pos=qp, k_pos=kp, **kw),
                iters=5)["kernels_per_call"]
            if n_kernels >= 1:
                break
        if n_kernels != 1:
            fail(f"flash_decode {name}: {n_kernels} kernels a call, not 1")
        worst = max(worst, err)
        out["cases"][name] = {"max_abs_err": err, "tol_share": share,
                              "kernels_per_call": n_kernels,
                              "plan": plan._asdict()}
        if name not in FD_TIMED:
            continue
        # the decode path reads each layer's cache once, after the layer
        # before streamed its weights through L2: time over copies of the
        # cache that together exceed the 50 MB L2, taken in turn
        n_copy = 1 + (100 << 20) // (2 * B * C * K * D * q.element_size())
        copies = itertools.cycle([(k.clone(), v.clone())
                                  for _ in range(n_copy)])
        mask = (kp > -(10 ** 8))[:, None, None, :]

        def kernel():
            kc, vc = next(copies)
            flash_decode(q, kc, vc, q_pos=qp, k_pos=kp, **kw)

        def library():
            kc, vc = next(copies)
            F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        ms = device_ms(torch, kernel, iters=50)
        wall = time_ms(torch, kernel, iters=50)
        plain_ms = device_ms(torch, plain, iters=10)
        lib = device_ms(torch, library, iters=50)
        timed = {"ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
                 "library_ms": lib,
                 "library": "scaled_dot_product_attention(enable_gqa, "
                            "bool mask), one query token",
                 "l2_cold_copies": n_copy,
                 "shape": [B, C, H, K, D], "pos": pos,
                 **_fd_bound(torch, q, kp, K)}
        if name == "decode_a":
            out.update(timed)
        else:
            out[name] = timed
    out["max_abs_err"] = worst
    return out


# ---------------------------------------------------------------------------
# phase 6: LM serving at full width
# ---------------------------------------------------------------------------

def _lm_prompts(cfg, B, S, extra=0, seed=0):
    import torch

    from repro_torch.data.lm_data import make_lm_source
    src = make_lm_source(seed, B, S + extra, cfg.vocab)
    return torch.from_numpy(src["tokens"])


def _teacher_forced(torch, params, cfg, toks, S, impl, media=None,
                    memory=None):
    """Prefill ``toks[:, :S]`` and decode the rest fed the true tokens:
    the last prefill logits and each decode step's over the real vocab,
    (steps, B, vocab), and the caches (one slot to spare for a follow-on
    step). ``media`` go before the prompt (the steps' positions shift by
    their count); ``memory`` is an enc-dec model's encoder output."""
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    dev = params["embed"]["table"].device
    toks = toks.to(dev)
    n = 0 if media is None else media.shape[1]
    logits, caches = make_prefill_step(cfg, impl)(
        params, toks[:, :S], media=media, memory=memory)
    caches = extend_caches(caches, cfg, n + toks.shape[1] + 1)
    steps = [logits[:, -1]]
    decode = make_decode_step(cfg, impl)
    for t in range(S, toks.shape[1]):
        lg, caches = decode(params, toks[:, t:t + 1], caches, n + t,
                            memory=memory)
        steps.append(lg[:, 0])
    return torch.stack(steps)[..., :cfg.vocab], caches


def _prefill_device_ms(torch, params, cfg, prompt):
    """Device time of one kernel-path prefill of ``prompt`` (all its
    kernels, ``torch.profiler``), after a warm-up."""
    from repro_torch.train.serve import make_prefill_step
    prefill = make_prefill_step(cfg, "pallas")
    toks = prompt.to(params["embed"]["table"].device)
    return device_ms(torch, lambda: prefill(params, toks), iters=3, warm=1)


def _gen_run(torch, params, cfg, prompt, n_new, counters):
    from repro_torch.train.serve import greedy_generate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    timings = {}
    toks, logits = greedy_generate(params, cfg, prompt, n_new,
                                   impl="pallas", device=DEVICE,
                                   return_logits=True, timings=timings)
    launches = {k: c.launches for k, c in counters.items()}
    B, S = prompt.shape
    if not (toks.shape == (B, n_new) and bool(torch.isfinite(logits).all())
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab):
        fail(f"lm_serve B={B} S={S}: bad tokens or non-finite logits")
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * (n_new - 1)}
    if launches != want:
        fail(f"lm_serve B={B} S={S}: launches {launches}, design implies "
             f"{want} (one per layer per prefill / decode step)")
    info = {"batch": B, "prompt": S, "new": n_new, "launches": launches,
            "prefill_s": timings["prefill_s"],
            "prefill_tok_per_s": B * S / timings["prefill_s"],
            "decode_s": timings["decode_s"],
            "decode_tok_per_s": B * (n_new - 1) / timings["decode_s"],
            "decode_ms_per_step": timings["decode_s"] / (n_new - 1) * 1e3,
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    return toks, logits, info


def lm_serve_phase(torch, counters):
    from repro_torch import interop
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer
    from repro_torch.models.common import normal_init
    cfg = h2o_danube_1_8b.CONFIG
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.lm_init(gen, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in interop.leaves(params).values())

    # (a) B=8, prompt 1024, 32 new; twice, bitwise
    prompt_a = _lm_prompts(cfg, 8, 1024, seed=1)
    toks_a, logits_a, run_a = _gen_run(torch, params, cfg, prompt_a, 32,
                                       counters)
    toks_a2, logits_a2, run_a2 = _gen_run(torch, params, cfg, prompt_a, 32,
                                          counters)
    if not (torch.equal(toks_a, toks_a2) and torch.equal(logits_a,
                                                         logits_a2)):
        fail("lm_serve (a): two kernel-path runs differ bitwise")
    # (b) B=1, prompt 4200 (past the 4096 window), 16 new
    prompt_b = _lm_prompts(cfg, 1, 4200, seed=2)
    _, logits_b, run_b = _gen_run(torch, params, cfg, prompt_b, 16,
                                  counters)
    del logits_b

    # teacher-forced logits, kernel path vs plain path, bf16 compute
    tf_toks = _lm_prompts(cfg, 8, 1024, extra=8, seed=1)
    S = tf_toks.shape[1] - 8
    prefill_ms = _prefill_device_ms(torch, params, cfg, tf_toks[:, :S])
    got, caches = _teacher_forced(torch, params, cfg, tf_toks, S, "pallas")
    want, _ = _teacher_forced(torch, params, cfg, tf_toks, S, "chunked")
    scale = float(want.abs().max())
    tf_err = float((got - want).abs().max())
    per_step = (got - want).abs().amax(dim=(1, 2)).tolist()
    if not tf_err <= LM_TOL_BF16 * scale:
        fail(f"lm_serve teacher-forced bf16 logits: max_abs_err {tf_err} > "
             f"{LM_TOL_BF16}*{scale} (per step {per_step})")
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    del got, want

    # task heads: one task= decode step of a 3-head tree from the kernel
    # path's caches (each path writes its slot into its own copy)
    from repro_torch.train.serve import make_decode_step
    cfg3 = cfg.replace(n_tasks=3)
    params3 = dict(params, task_heads={"w": normal_init(
        gen, (3, cfg.d_model, cfg.padded_vocab), cfg.param_dtype, 0.02,
        dev)})
    nxt = tf_toks[:, -1:].to(dev)
    task_out = {}
    for impl in ("pallas", "chunked"):
        c = interop.tree_map(torch.clone, caches)
        lg, _ = make_decode_step(cfg3, impl, task=1)(params3, nxt, c,
                                                     tf_toks.shape[1])
        task_out[impl] = lg[:, 0, :cfg.vocab]
    task_err = float((task_out["pallas"] - task_out["chunked"]).abs().max())
    task_scale = float(task_out["chunked"].abs().max())
    if not task_err <= LM_TOL_BF16 * task_scale:
        fail(f"lm_serve task head: max_abs_err {task_err} > "
             f"{LM_TOL_BF16}*{task_scale}")
    del params3, caches, task_out

    # the same check in f32 compute: the kernels' arithmetic, no bf16 flips
    cfg32 = cfg.replace(compute_dtype=torch.float32)
    tf32 = _lm_prompts(cfg, 2, 256, extra=4, seed=3)
    S32 = tf32.shape[1] - 4
    got32, _ = _teacher_forced(torch, params, cfg32, tf32, S32, "pallas")
    want32, _ = _teacher_forced(torch, params, cfg32, tf32, S32, "chunked")
    atol, rtol = LM_TOL_F32
    f32_err = float((got32 - want32).abs().max())
    if not torch.allclose(got32, want32, atol=atol, rtol=rtol):
        fail(f"lm_serve teacher-forced f32 logits: max_abs_err {f32_err} "
             f"beyond atol {atol} / rtol {rtol}")
    return {"phase": "lm_serve", "config": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
            "head_dim": cfg.hd, "window": cfg.window, "params": n_params,
            "init_s": init_s, "compute_dtype": "bfloat16", "impl": "pallas",
            "run_a": run_a, "run_a_replay": run_a2, "run_b": run_b,
            "replay_bitwise": True, "prefill_device_ms": prefill_ms,
            "allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction,
            "teacher_forced": {
                "steps": len(per_step), "bf16_max_abs_err": tf_err,
                "bf16_max_abs_logit": scale, "bf16_per_step": per_step,
                "bf16_tolerance": LM_TOL_BF16 * scale,
                "argmax_agreement": agree, "f32_max_abs_err": f32_err,
                "f32_tolerance": list(LM_TOL_F32)},
            "task_head": {"n_tasks": 3, "task": 1, "max_abs_err": task_err,
                          "tolerance": LM_TOL_BF16 * task_scale}}


def lm_profile(torch):
    """Device time by kernel for one full-width prefill (B=8, S=1024) and
    one decode step (B=8, cache 1056), kernel path, after a warm-up of
    each."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer
    from repro_torch.train.serve import (extend_caches, make_decode_step,
                                         make_prefill_step)
    cfg = h2o_danube_1_8b.CONFIG
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.lm_init(gen, cfg, device=dev)
    toks = _lm_prompts(cfg, 8, 1024, extra=3, seed=1).to(dev)
    prefill = make_prefill_step(cfg, "pallas")
    decode = make_decode_step(cfg, "pallas")

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        return out, _device_time_by_kernel(torch, prof, wall_us)
    prefill(params, toks[:, :1024])                         # warm-up
    (_, caches), pre = traced(lambda: prefill(params, toks[:, :1024]))
    caches = extend_caches(caches, cfg, 1056)
    decode(params, toks[:, 1024:1025], caches, 1024)        # warm-up
    _, dec = traced(lambda: decode(params, toks[:, 1025:1026], caches, 1025))
    # wall times under the profiler, which slows the host side: the idle
    # shares read from them are upper estimates
    return {"phase": "profile_lm", "config": cfg.name,
            "batch": "prefill B=8 S=1024; decode B=8 cache 1056",
            "prefill": pre, "decode_step": dec}


def _fd_plan(fd_ops, q, k, n_splits=None, block_k=None) -> dict:
    """The split plan #6 takes for these inputs (an earlier checkout's
    ``plan_splits`` gives only its split count and length)."""
    if hasattr(fd_ops, "plan_call"):
        return fd_ops.plan_call(q, k, n_splits, block_k)._asdict()
    n, per = fd_ops.plan_splits(k.shape[0], k.shape[2], k.shape[1],
                                n_splits, block_k)[:2]
    return {"n_splits": n, "per_split": per}


def _fd_bound(torch, q, kp, K) -> dict:
    """#6's bound: q in and the output out, the k/v rows of the valid keys
    only (pads and slots past the window are not needed), k_pos and
    q_pos; 4·D FLOP a (head, valid key)."""
    B, _, H, D = q.shape
    valid = int((kp > -(10 ** 8)).sum())
    nbytes = q.element_size() * (2 * B * H * D + 2 * valid * K * D) \
        + 4 * (kp.numel() + B)
    return {"valid_keys": valid,
            **_bound(torch, 4 * D * H * valid, nbytes, q.dtype)}


# #5 and #6 at the local-head shapes of train_dist's 4-rank job, a rank's
# share: (k) seamless's 8 of 16 heads (f32 as served there, and bf16, its
# configured dtype) and (i) deepseek-v2's 64 of 128 MLA heads
LOCAL_FA = [  # name, dtype, B, Sq, Sk, H, K, D, causal, positions
    ("seamless_encoder_8h", "float32", 1, 1024, 1024, 8, 8, 64, False,
     False),
    ("seamless_cross_prefill_8h", "float32", 1, 512, 1024, 8, 8, 64, False,
     "zeros"),
    ("seamless_cross_decode_8h", "float32", 1, 1, 1024, 8, 8, 64, False,
     "zeros"),
    ("seamless_encoder_8h_bf16", "bfloat16", 1, 1024, 1024, 8, 8, 64,
     False, False),
    ("seamless_cross_prefill_8h_bf16", "bfloat16", 1, 512, 1024, 8, 8, 64,
     False, "zeros"),
    ("seamless_cross_decode_8h_bf16", "bfloat16", 1, 1, 1024, 8, 8, 64,
     False, "zeros"),
    ("mla_prefill_64h", "bfloat16", 1, 512, 512, 64, 64, 192, True, False),
]
LOCAL_FD = [  # name, dtype, B, C, H, K, D, pos
    ("seamless_decode_8h", "float32", 1, 520, 8, 8, 64, 519),
    ("seamless_decode_8h_bf16", "bfloat16", 1, 520, 8, 8, 64, 519),
]


def local_head_times(torch):
    """#5 and #6 at ``LOCAL_FA`` / ``LOCAL_FD``, each checked against its
    plain version (``_attn_err``) and timed by CUDA events (``time_ms``:
    the kernel, its plain version and ``scaled_dot_product_attention`` on
    the same inputs), beside the bound of ``_bound`` / ``_fd_bound``, and
    the kernel's and SDPA's device time (``device_ms``): at these shapes
    back-to-back calls can wait on the host, which CUDA events count. #6
    reads its cache from copies that together exceed the L2, as
    ``check_flash_decode`` times it."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    from repro_torch.kernels.flash_attention.ref import keep_mask
    from repro_torch.kernels.flash_decode import decode_ref, flash_decode
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    out = {"phase": "local_head_times", "timer": "CUDA events",
           "flash_attention": {}, "flash_decode": {}}
    for name, dt, B, Sq, Sk, H, K, D, causal, zeros in LOCAL_FA:
        dt = getattr(torch, dt)
        q, k, v = (torch.randn((B, n, h, D), generator=g, device=dev).to(dt)
                   for n, h in ((Sq, H), (Sk, K), (Sk, K)))
        kp = torch.arange(Sk, device=dev, dtype=torch.int32)
        qp = torch.arange(Sk - Sq, Sk, device=dev, dtype=torch.int32)
        if zeros:
            qp, kp = torch.zeros_like(qp), torch.zeros_like(kp)
        err, share = _attn_err(
            torch, flash_attention(q, k, v, q_pos=qp, k_pos=kp,
                                   causal=causal),
            flash_attention_ref(q, k, v, qp, kp, causal=causal), name)
        keep = keep_mask(qp.long(), kp.long(), causal=causal, window=0)
        lib_mask = None if bool(keep.all()) else keep
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = int(keep.sum()) * B * H
        nbytes = q.element_size() * (2 * B * Sq * H * D + 2 * B * Sk * K * D) \
            + 4 * (Sq + Sk)
        def kernel():
            flash_attention(q, k, v, q_pos=qp, k_pos=kp, causal=causal)

        def library():
            F.scaled_dot_product_attention(qt, kt, vt, attn_mask=lib_mask,
                                           enable_gqa=True)
        out["flash_attention"][name] = {
            "shape": [B, Sq, Sk, H, K, D], "causal": causal,
            "max_abs_err": err, "tol_share": share,
            "ms": time_ms(torch, kernel, iters=20),
            "plain_ms": time_ms(torch, lambda: flash_attention_ref(
                q, k, v, qp, kp, causal=causal), iters=5),
            "library_ms": time_ms(torch, library, iters=20),
            "device_ms": device_ms(torch, kernel, iters=10),
            "library_device_ms": device_ms(torch, library, iters=10),
            **_bound(torch, 4 * D * pairs, nbytes, dt)}
    for name, dt, B, C, H, K, D, pos in LOCAL_FD:
        dt = getattr(torch, dt)
        q = torch.randn((B, 1, H, D), generator=g, device=dev).to(dt)
        k, v = (torch.randn((B, C, K, D), generator=g, device=dev).to(dt)
                for _ in range(2))
        kp = _cache_positions(torch, dev, C, pos, 0)[None].expand(B, C)
        qp = torch.full((B,), pos, device=dev, dtype=torch.int32)
        err, share = _attn_err(
            torch, flash_decode(q, k, v, q_pos=qp, k_pos=kp),
            decode_ref(q, k, v, q_pos=qp, k_pos=kp), name)
        n_copy = 1 + (100 << 20) // (2 * B * C * K * D * q.element_size())
        copies = itertools.cycle([(k.clone(), v.clone())
                                  for _ in range(n_copy)])
        mask = (kp > -(10 ** 8))[:, None, None, :]

        def kernel():
            kc, vc = next(copies)
            flash_decode(q, kc, vc, q_pos=qp, k_pos=kp)

        def library():
            kc, vc = next(copies)
            F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        out["flash_decode"][name] = {
            "shape": [B, C, H, K, D], "pos": pos, "max_abs_err": err,
            "tol_share": share, "l2_cold_copies": n_copy,
            "ms": time_ms(torch, kernel, iters=50),
            "plain_ms": time_ms(torch, lambda: decode_ref(
                q, k, v, q_pos=qp, k_pos=kp), iters=10),
            "library_ms": time_ms(torch, library, iters=50),
            "device_ms": device_ms(torch, kernel, iters=50),
            "library_device_ms": device_ms(torch, library, iters=50),
            **_fd_bound(torch, q, kp, K)}
    return out


# the LM decode shapes of runs (a) and (b): name, B, cache slots, position
FD_SWEEP = (("decode_a", 8, 1056, 1040), ("decode_b_rolling", 1, 4200, 4210))
FD_SWEEP_SPLITS = (1, 2, 3, 4, 9, 17, 33, None)   # run (a); None: default


def attn_sweep(torch):
    """Device time per call of #5 over masks, each beside
    ``scaled_dot_product_attention`` on the same inputs (the bool keep mask,
    as ``library_ms`` takes it, and SDPA's own causal / unmasked form where
    the mask has one), at the LM prefill shape (B=8, S=1024, bf16); and of
    #6 at the LM decode shapes of runs (a) and (b) (window 4096 folded into
    k_pos, as the decode path passes it), over split counts and the default
    plan at (a), the default plan at (b), each with its device time by
    kernel name, kernels a call, its time with the host's share (CUDA
    events, ``wall_ms``), its plan and the waves the card takes for it,
    beside SDPA and the bound. Inputs are L2-warm: the measurements behind
    the kernels' redesign notes."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import keep_mask
    from repro_torch.kernels.flash_decode import ops as fd_ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()
    B, S, H, K, D = 8, 1024, 32, 8, 80
    fa_shape = [B, S, H, K, D]
    q, k, v = t(B, S, H, D), t(B, S, K, D), t(B, S, K, D)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    fa = {}
    for mask, kw, native in (
            ("causal", dict(causal=True), dict(is_causal=True)),
            ("causal_window_64", dict(causal=True, window=64), None),
            ("none", dict(causal=False), {})):
        keep = keep_mask(pos.long(), pos.long(), causal=kw["causal"],
                         window=kw.get("window", 0))
        got = flash_attention(q, k, v, q_pos=pos, k_pos=pos, **kw)
        row = {"kernel": device_ms(torch, lambda: flash_attention(
            q, k, v, q_pos=pos, k_pos=pos, **kw), iters=10),
            # the output's bits, to hold two versions to the same result
            "sha256": hashlib.sha256(
                # lint: allow(TRC003): one output hash a case
                got.view(torch.int16).cpu().numpy().tobytes()).hexdigest(),
            "sdpa_bool_mask": device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=keep, enable_gqa=True), iters=10)}
        if native is not None:
            row["sdpa_native"] = device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **native), iters=10)
        fa[mask] = row
    fd = {}
    for name, B, C, p in FD_SWEEP:
        q1, kc, vc = t(B, 1, H, D), t(B, C, K, D), t(B, C, K, D)
        kp = _cache_positions(torch, dev, C, p, 4096)[None].expand(B, C)
        qp = torch.full((B,), p, device=dev, dtype=torch.int32)
        mask = (kp > -(10 ** 8))[:, None, None, :]
        row = {"shape": [B, C, H, K, D], "pos": p,
               "sdpa_ms": device_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       q1.transpose(1, 2), kc.transpose(1, 2),
                       vc.transpose(1, 2), attn_mask=mask, enable_gqa=True),
                   iters=50),
               **_fd_bound(torch, q1, kp, K)}
        if hasattr(fd_ops, "max_active_clusters"):
            # the card's occupancy of this instantiation: clusters of
            # 1..16 CTAs (one split each) that one wave holds, by ring depth
            row["max_active_clusters"] = {
                f"stages_{st}": [fd_ops.max_active_clusters(
                    dev.index or 0, q1.dtype, H // K, D, c, st, 1)
                    for c in range(1, fd_ops.MAX_CLUSTER + 1)]
                for st in fd_ops.STAGES}
        for n in FD_SWEEP_SPLITS if name == "decode_a" else (None,):
            def call():
                fd_ops.flash_decode(q1, kc, vc, q_pos=qp, k_pos=kp,
                                    n_splits=n)
            plan = _fd_plan(fd_ops, q1, kc, n)
            cell = {**device_profile(torch, call, iters=50),
                    # CUDA events around back-to-back calls: the host's
                    # share of a call included
                    "wall_ms": time_ms(torch, call, iters=200),
                    "plan": plan}
            if "cluster" in plan:
                # the card's clusters a wave at this plan, and the waves
                # the B·K clusters take
                per_wave = fd_ops.max_active_clusters(
                    dev.index or 0, q1.dtype, H // K, D, plan["cluster"],
                    plan["stages"], plan["splits_per_cta"])
                cell.update(clusters_a_wave=per_wave,
                            waves=-(-B * K // per_wave))
            row[f"splits_{n or 'default'}"] = cell
        fd[name] = row
    return {"phase": "attn_sweep", "flash_attention_shape": fa_shape,
            "flash_attention_ms_by_mask": fa, "flash_decode": fd}


def ss_sweep(torch):
    """Device time per call of #1 (one graph, 2-D) and #2 (B=8) at the
    serve path's graph shape (E=2048, A=64, F=866, f32, 85% of edges
    valid), each beside ``index_add_`` on the same inputs and its byte
    bound; the inputs come from their own seed, so two versions (``--src``)
    see the same data."""
    from repro_torch.kernels.segment_sum import ops, segment_sum_ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    B, E, A, F = 8, 2048, 64, 866
    msg = torch.randn((B, E, F), generator=g, device=dev)
    _, dst, em = edge_case(torch, B, E, A, g, dev)
    routed = torch.where(em, dst, torch.full_like(dst, A))
    out = {}
    for name, m, d, e in (("1_segment_sum_2d", msg[0], routed[0], em[0]),
                          ("2_segment_sum_batched", msg, routed, em)):
        d32 = d.to(torch.int32).contiguous()
        got = ops.segment_sum(m, d32, A)
        err, scale = scaled_err(torch, got, segment_sum_ref(m, d, A))
        if not err <= SS_TOL * scale:
            fail(f"ss_sweep {name}: max_abs_err {err} > {SS_TOL}*{scale}")
        b = m.shape[0] if m.dim() == 3 else 1
        n_valid = int(e.sum())
        out[name] = {
            "shape": [b, E, A, F], "valid_edges": n_valid,
            "ms": device_ms(torch, lambda: ops.segment_sum(m, d32, A),
                            iters=50),
            "wall_ms": time_ms(torch, lambda: ops.segment_sum(m, d32, A),
                               iters=50),
            "library_ms": device_ms(torch, _ss_library(torch, m, d, e, A),
                                    iters=50),
            # every edge routed to the sentinel: the dst walk, the zero
            # writes and the launch, no message loaded
            "walk_only_ms": device_ms(torch, lambda: ops.segment_sum(
                m, torch.full_like(d32, A), A), iters=50),
            "max_abs_err": err, **_ss_bound(b, E, A, F, n_valid)}
    out["1_embedding"] = _embed_sweep(torch, g)
    return {"phase": "ss_sweep", **out}


EMBED_BLOCK_N = (24, 48, 96, 192, 384, 768, 1536)


def _embed_sweep(torch, g):
    """#1 at the embedding's backward (phase ``lm_train``'s batch: 8 x
    1024 qwen1.5-0.5b tokens from ``lm_data``, bf16 rows of 1024 into
    152064): device time by node block at the whole-list window (the
    default plan's 384 among them, every block the same bits), beside
    ``index_add_``, and the same over ids drawn uniformly from the vocab:
    the Zipf draw puts most ids in the first node block, whose CTA sums
    them one after another."""
    import numpy as np
    from repro_torch.configs import qwen1_5_0_5b
    from repro_torch.data.lm_data import make_lm_sources
    from repro_torch.kernels.segment_sum import ops
    cfg = qwen1_5_0_5b.CONFIG
    V, D = cfg.padded_vocab, cfg.d_model
    dev = torch.device("cuda")
    toks = make_lm_sources(1, 64, LM_S, cfg.vocab)[0]["tokens"][:LM_B]
    zipf = torch.from_numpy(toks.reshape(-1).astype(np.int32)).to(dev)
    uniform = torch.randint(0, cfg.vocab, zipf.shape, generator=g,
                            device=dev, dtype=torch.int32)
    msg = (torch.randn((zipf.numel(), D), generator=g, device=dev)
           * 1e-3).to(torch.bfloat16)
    out = {"shape": [zipf.numel(), V, D], "dtype": "bfloat16",
           "default_plan": dict(ops.plan(V, zipf.numel(), D,
                                         itemsize=2)._asdict())}
    for name, ids in (("zipf", zipf), ("uniform", uniform)):
        want = ops.segment_sum(msg, ids, V)
        by_block = {}
        for bn in EMBED_BLOCK_N:
            if not torch.equal(ops.segment_sum(msg, ids, V, block_n=bn,
                                               block_e=ids.numel()), want):
                fail(f"ss_sweep embedding {name}: block_n={bn} changes the "
                     "bits")
            by_block[bn] = device_ms(torch, lambda: ops.segment_sum(
                msg, ids, V, block_n=bn, block_e=ids.numel()), iters=10)
        ids64 = ids.long()
        out[name] = {
            "ms_by_block_n": by_block,
            "first_block_ids": int((ids < 384).sum()),
            "top_id_count": int(ids.bincount().max()),
            # lint: allow(ATM001): library_ms yardstick, on no port path
            "library_ms": device_ms(torch, lambda: torch.zeros(
                (V, D), dtype=msg.dtype, device=dev).index_add_(
                    0, ids64, msg), iters=10)}
    return out


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        # lint: allow(TRC003): hashes each tensor's bytes in turn
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def edge_sweep(torch):
    """#4 by device time and kernel name at the training path's shape
    (B=40, no dpos) and at B=8 with dpos, with a hash of its outputs; #3
    at both shapes by kernel, with a hash of its outputs (and scratch) and
    the relative error of its output against a float64 forward on the same
    inputs; where the checkout's #3 takes a plan override, its device time
    over split counts (proj, fc1) and column tiles; one full-width training
    step's device time by kernel (``torch.profiler``) and its host-clock ms
    a step over 5 steps. Inputs from their own seed, so two versions
    (``--src``) see the same data."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.egnn_edge import egnn_edge_agg, ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    out = {"phase": "edge_sweep"}
    plans = "splits" in inspect.signature(ops._launch_fwd).parameters
    for name, B, need_dpos in (("b40", 40, False), ("b8", 8, True)):
        leaves, edges, gup = _edge_bwd_inputs(torch, g, dev, B, 64, 2048)
        call, sr, dr = _edge_bwd_call(torch, leaves, edges, gup, need_dpos)
        prof = device_profile(torch, call)
        out[f"bwd_{name}"] = {
            "dpos": need_dpos, "ms": prof["ms"],
            "by_kernel": prof["by_kernel"],
            "kernels_per_call": prof["kernels_per_call"],
            "sha256": _sha(x for x in call() if x is not None)}
        h, pos, w0, b0, w1, b1 = (x.detach() for x in leaves)
        phi = {"fc0": {"w": w0, "b": b0}, "fc1": {"w": w1, "b": b1}}
        fwd = _edge_fwd_call(torch, h, pos, *edges, phi)
        prof = device_profile(torch, fwd)
        n_valid = int(edges[2].sum())
        with torch.no_grad():
            got = egnn_edge_agg(h, pos, *edges, phi)
            exact = _edge_fwd_plain(torch, h, pos, *edges, phi,
                                    torch.float64)[0]
        out[f"fwd_{name}"] = {
            "ms": prof["ms"], "by_kernel": prof["by_kernel"],
            "kernels_per_call": prof["kernels_per_call"],
            "sha256": _sha(fwd()), "valid_edges": n_valid,
            "rel_err_vs_f64": float((got.double() - exact).abs().max()
                                    / exact.abs().max()),
            **_edge_fwd_bound(B, 64, 2048, 866, n_valid)}
        del got, exact
        if plans:
            by_plan = {}
            for sp in ((1, 1), (1, 2), (2, 2), (2, 4), (4, 4)):
                by_plan[f"splits_{sp[0]}_{sp[1]}"] = device_profile(
                    torch, _edge_fwd_call(torch, h, pos, *edges, phi,
                                          splits=sp))["by_kernel"]
            for bh in (32, 64, 128):
                by_plan[f"block_h_{bh}"] = device_profile(
                    torch, lambda: egnn_edge_agg(
                        h, pos, *edges, phi, block_h=bh))["by_kernel"]
            out[f"fwd_{name}"]["by_plan"] = by_plan
        out[f"bwd_{name}"].update(
            valid_edges=n_valid,
            **_edge_bwd_bounds(B, 64, 2048, 866, n_valid, need_dpos))
    with _train_session(torch, _train_sources(), 3) as sess:
        batches = sess._batches()
        state = sess.state
        for _ in range(2):
            state, _ = sess.step_fn(state, batches())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = sess.step_fn(state, batches())
            torch.cuda.synchronize()
        step = _device_time_by_kernel(torch, prof)
        t0 = time.perf_counter()
        for _ in range(5):
            state, _ = sess.step_fn(state, batches())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
    out["train_step"] = {"device_ms": step["device_us_total"] / 1e3,
                         "launches": step["launches"], "top": step["top"],
                         "ms_per_step": step_ms}
    return out


def lm_bf16_probe(torch):
    """The bf16 GEMM reduction setting in force, the device time of one
    kernel-path prefill at run (a) (B=8, S=1024), the teacher-forced bf16
    error of the lm_serve phase (prefill + 8 decode steps, kernel path
    against the plain path, the same seeds) and run (a)'s decode time a
    step on the host's clock, so that two versions (``--src``) can be
    compared in one call."""
    from repro_torch.configs import h2o_danube_1_8b
    from repro_torch.models import transformer
    cfg = h2o_danube_1_8b.CONFIG
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = transformer.lm_init(gen, cfg, device=dev)
    tf_toks = _lm_prompts(cfg, 8, 1024, extra=8, seed=1)
    S = tf_toks.shape[1] - 8
    prefill_ms = _prefill_device_ms(torch, params, cfg, tf_toks[:, :S])
    got, _ = _teacher_forced(torch, params, cfg, tf_toks, S, "pallas")
    want, _ = _teacher_forced(torch, params, cfg, tf_toks, S, "chunked")
    # run (a)'s generation (B=8, prompt 1024, 32 new) on the host's clock,
    # after one run to warm up
    from repro_torch.train.serve import greedy_generate
    prompt = _lm_prompts(cfg, 8, 1024, seed=1)
    for _ in range(2):
        timings = {}
        greedy_generate(params, cfg, prompt, 32, impl="pallas", device=dev,
                        timings=timings)
    return {"phase": "lm_bf16",
            "decode_ms_per_step": timings["decode_s"] / 31 * 1e3,
            "decode_tok_per_s": 8 * 31 / timings["decode_s"],
            "allow_bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul
                .allow_bf16_reduced_precision_reduction,
            "prefill_device_ms": prefill_ms,
            "teacher_forced_bf16_max_abs_err":
                float((got - want).abs().max()),
            "bf16_max_abs_logit": float(want.abs().max()),
            "bf16_tolerance": LM_TOL_BF16 * float(want.abs().max())}


def _device_time_by_kernel(torch, prof, wall_us=None):
    """Device time by kernel: only events that ran on the device, so the
    host ops and autograd nodes that launched a kernel (which the profiler
    also credits with its time) do not count it again."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = ev.device_time_total
        if dt:
            rows.append((dt, ev.key[:60], ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    out = {"device_us_total": busy, "kernels": len(rows),
           "launches": sum(r[2] for r in rows),
           "top": [{"kernel": k, "us": t, "calls": c}
                   for t, k, c in rows[:12]]}
    if wall_us is not None:
        out.update(wall_us=wall_us, device_idle_share=1 - busy / wall_us)
    return out


def profile_phase(torch):
    """Device time by kernel name (``torch.profiler``) for the forward of
    one full-width served batch (8 rows of A=64, E=2048), per impl."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import interop
    from repro_torch.configs.hydragnn_gfm import CONFIG
    from repro_torch.core.mtl import gfm_mtl_init
    from repro_torch.data.synthetic_atoms import generate_source
    from repro_torch.models import gnn, heads
    dev = torch.device("cuda")
    params = interop.to_torch(gfm_mtl_init(CONFIG, 1, seed=0), dev)
    hp = {br: {fc: {p: t[0] for p, t in layer.items()}
               for fc, layer in mlp.items()}
          for br, mlp in params["heads"].items()}
    s = generate_source("mptrj", 8, max_atoms=64, max_edges=2048, seed=0)
    batch = {k: torch.from_numpy(getattr(s, k)).to(dev) for k in
             ("species", "pos", "edge_src", "edge_dst", "node_mask",
              "edge_mask")}
    out = {}
    for impl in ("fused", "pallas"):
        cfg = CONFIG.replace(segment_sum_impl=impl)

        def fwd():
            with torch.inference_mode():
                f = gnn.egnn_apply(params["shared"], batch, cfg=cfg)
                return heads.branch_apply(hp, f, batch["node_mask"], cfg=cfg)
        fwd()
        # lint: allow(TRC003): the trace spans exactly the kernels
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fwd()
            # lint: allow(TRC003): the trace spans exactly the kernels
            torch.cuda.synchronize()
        out[impl] = _device_time_by_kernel(torch, prof)
    # one full-width training step (5 tasks x 8 graphs, fused), after two
    # warm-up steps
    with _train_session(torch, _train_sources(), 3) as sess:
        batches = sess._batches()
        state = sess.state
        for _ in range(2):
            state, _ = sess.step_fn(state, batches())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = sess.step_fn(state, batches())
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # the step's wall time is taken under the profiler, which slows the
    # host side: the idle share read from it is an upper estimate
    out["train_step"] = _device_time_by_kernel(torch, prof, wall_us)
    return {"phase": "profile", "batch": "mptrj B=8 A=64 E=2048; train "
            "step 5 tasks x 8 graphs", **out}


def sweep_in_turns(other: Path):
    """``--sweep`` for ``other`` (an earlier checkout's src/) and this
    checkout in turns, parent, change, change, parent, each in its own
    process; every line tagged with its turn, then a summary of the
    kernels' device times by turn."""
    turns = [("parent", other), ("change", SRC), ("change", SRC),
             ("parent", other)]
    summary = []
    for i, (version, src) in enumerate(turns):
        r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--sweep", "--once", "--src", str(src)],
                           stdout=subprocess.PIPE, text=True)
        row = {"turn": i, "version": version}
        for line in r.stdout.splitlines():
            if not line.startswith("{"):
                print(line, flush=True)
                continue
            rec = json.loads(line)
            emit({"turn": i, "version": version, **rec})
            if rec.get("phase") == "ss_sweep":
                row.update({k: rec[k]["ms"] for k in rec if k != "phase"})
            elif rec.get("phase") == "attn_sweep":
                fa = rec["flash_attention_ms_by_mask"]
                row["flash_attention_causal"] = fa["causal"]["kernel"]
                row["flash_attention_sha256"] = {
                    k: v["sha256"][:16] for k, v in fa.items()}
                for k, v in rec["flash_decode"].items():
                    row[f"flash_{k}_default"] = v["splits_default"]["ms"]
                    row[f"flash_{k}_default_wall"] = \
                        v["splits_default"]["wall_ms"]
                row["flash_decode_a_ms_by_splits"] = {
                    k[len("splits_"):]: v["ms"]
                    for k, v in rec["flash_decode"]["decode_a"].items()
                    if k.startswith("splits_")}
            elif rec.get("phase") == "lm_bf16":
                row["decode_ms_per_step"] = rec["decode_ms_per_step"]
            elif rec.get("phase") == "edge_sweep":
                for k in ("bwd_b40", "bwd_b8", "fwd_b40", "fwd_b8"):
                    row[f"egnn_edge_{k}"] = {
                        x: rec[k][x] for x in ("ms", "by_kernel",
                                               "kernels_per_call", "sha256",
                                               "rel_err_vs_f64", "bound_ms",
                                               "bound_ffma_ms")
                        if x in rec[k]}
                row["train_step_device_ms"] = rec["train_step"]["device_ms"]
                row["train_step_launches"] = rec["train_step"]["launches"]
                row["train_step_ms"] = rec["train_step"]["ms_per_step"]
        if r.returncode != 0:
            fail(f"--sweep for {src} exited {r.returncode}")
        summary.append(row)
    emit({"phase": "sweep_summary", "ms_by_turn": summary,
          "flash_attention_bits_equal": len({json.dumps(
              r["flash_attention_sha256"]) for r in summary}) == 1,
          "egnn_edge_fwd_bits_equal_by_version": {
              v: len({(r["egnn_edge_fwd_b40"]["sha256"],
                       r["egnn_edge_fwd_b8"]["sha256"])
                      for r in summary if r["version"] == v}) == 1
              for v in ("parent", "change")},
          "egnn_edge_bwd_bits_equal_by_version": {
              v: len({(r["egnn_edge_bwd_b40"]["sha256"],
                       r["egnn_edge_bwd_b8"]["sha256"])
                      for r in summary if r["version"] == v}) == 1
              for v in ("parent", "change")}})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one served "
                         "batch, one train step, one LM prefill and one "
                         "decode step, and of #5 over masks and #6 over "
                         "split counts")
    ap.add_argument("--sweep", action="store_true",
                    help="only build the kernels and print the sweeps (#4 "
                         "and #3 at B=40 and B=8, a training step; #1 and "
                         "#2 beside index_add_; #5 beside SDPA over masks, "
                         "#6 over split counts; the LM prefill's device time "
                         "and bf16 error), then exit; no contract line")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src/ directory whose repro_torch to import "
                         "(default: this checkout's), e.g. an unpacked "
                         "earlier commit's; with --sweep, the sweeps run "
                         "for it and for this checkout in turns: it, this, "
                         "this, it")
    ap.add_argument("--phase", choices=("analysis", "train_mtp",
                                        "train_dist", "dryrun", "train"),
                    help="only build the kernels and run this phase, then "
                         "exit; no contract line")
    ap.add_argument("--local-heads", action="store_true",
                    help="only build the kernels and time #5 and #6 at the "
                         "4-rank job's local-head shapes (LOCAL_FA, "
                         "LOCAL_FD) by CUDA events, then exit; no "
                         "contract line")
    ap.add_argument("--once", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    src = args.src.resolve()
    if args.sweep and not args.once and src != SRC.resolve():
        return sweep_in_turns(src)
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"{src / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    import repro_torch  # noqa: F401  (pins TF32 off)
    from repro_torch.kernels import _build
    from repro_torch.kernels.egnn_edge import ops as edge_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.segment_sum import ops as ss_ops

    smi = nvidia_smi()
    build = _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build["seconds"],
          "built": build["built"], "src": str(src)})
    if args.phase:
        _phase_start(torch, args.phase)
        counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                    "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
                    "segment_sum": ss_ops.segment_sum,
                    "segment_sum_2d": ss_ops.segment_sum.two_d}
        emit({"analysis": analysis_phase, "train_mtp": train_mtp_phase,
              "train_dist": train_dist_phase,
              "dryrun": lambda t: dryrun_phase(t, counters),
              "train": lambda t: train_phase(t, counters)}[args.phase](torch))
        return
    if args.local_heads:
        emit(local_head_times(torch))
        return
    if args.sweep:
        emit(edge_sweep(torch))
        emit(ss_sweep(torch))
        emit(attn_sweep(torch))
        emit(lm_bf16_probe(torch))
        return

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ss = check_segment_sum(torch, dev, g)
    emit({"phase": "kernel", "name": "segment_sum", "tolerance": SS_TOL, **ss})
    eg = check_egnn_edge(torch, dev, g)
    emit({"phase": "kernel", "name": "egnn_edge_fused", "tolerance": EDGE_TOL,
          **eg})
    eb = check_egnn_edge_bwd(torch, dev, g)
    emit({"phase": "kernel", "name": "egnn_edge_fused_bwd",
          "tolerance": BWD_TOL, **eb})
    eg16 = check_egnn_edge(torch, dev, g, torch.bfloat16)
    emit({"phase": "kernel", "name": "egnn_edge_fused_bf16",
          "tolerance": EDGE_BF16_TOL, **eg16})
    eb16 = check_egnn_edge_bwd_bf16(torch, dev, g)
    emit({"phase": "kernel", "name": "egnn_edge_fused_bwd_bf16",
          "tolerance": {"vs_plain": BWD_TOL,
                        "vs_f32_launch_on_upcast": "bitwise"}, **eb16})
    fa = check_flash_attention(torch, dev, g)
    emit({"phase": "kernel", "name": "flash_attention",
          "tolerance": {"f32": ATTN_TOL_F32, "bf16_rtol": ATTN_RTOL_BF16},
          **fa})
    fd = check_flash_decode(torch, dev, g)
    emit({"phase": "kernel", "name": "flash_decode",
          "tolerance": {"f32": ATTN_TOL_F32, "bf16_rtol": ATTN_RTOL_BF16},
          **fd})

    if args.profile:
        emit(attn_sweep(torch))
        emit(profile_phase(torch))
    _phase_start(torch, "serve")
    serve, serve_rows = serve_phase(torch, N_REQUESTS)
    emit(serve)
    gnn_counters = {"egnn_edge": edge_ops.egnn_edge_agg,
                    "egnn_edge_bwd": edge_ops.egnn_edge_bwd,
                    "segment_sum": ss_ops.segment_sum,
                    "segment_sum_2d": ss_ops.segment_sum.two_d}
    _phase_start(torch, "serve_scaleout")
    scaleout = serve_scaleout_phase(torch, serve, gnn_counters)
    emit(scaleout)
    _phase_start(torch, "train")
    train = train_phase(torch, gnn_counters)
    emit(train)
    bf16_counters = {**gnn_counters,
                     "egnn_edge_bf16": edge_ops.egnn_edge_agg.bf16,
                     "egnn_edge_bwd_bf16": edge_ops.egnn_edge_bwd.bf16}
    _phase_start(torch, "gnn_bf16")
    gnn16 = gnn_bf16_phase(torch, serve_rows, bf16_counters)
    emit(gnn16)
    del serve_rows
    _phase_start(torch, "train_pipeline")
    pipe = train_pipeline_phase(torch, gnn_counters)
    emit(pipe)
    _phase_start(torch, "analysis")
    analysis = analysis_phase(torch)
    emit(analysis)
    _phase_start(torch, "train_mtp")
    mtp = train_mtp_phase(torch)
    emit(mtp)
    _phase_start(torch, "finetune")
    fine = finetune_phase(torch, gnn_counters)
    emit(fine)
    _phase_start(torch, "lm_serve")
    lm = lm_serve_phase(torch, {"flash_attention": fa_ops.flash_attention,
                                "flash_decode": fd_ops.flash_decode})
    emit(lm)
    if args.profile:
        emit(lm_profile(torch))
    _phase_start(torch, "lm_train")
    lmt = lm_train_phase(torch, {
        "segment_sum_2d": ss_ops.segment_sum.two_d,
        "segment_sum": ss_ops.segment_sum,
        "flash_attention": fa_ops.flash_attention,
        "flash_decode": fd_ops.flash_decode})
    emit(lmt)
    lm_counters = {"segment_sum_2d": ss_ops.segment_sum.two_d,
                   "segment_sum": ss_ops.segment_sum,
                   "flash_attention": fa_ops.flash_attention,
                   "flash_decode": fd_ops.flash_decode}
    _phase_start(torch, "lm_moe")
    moe = lm_moe_phase(torch, lm_counters)
    emit(moe)
    _phase_start(torch, "lm_recurrent")
    rec = lm_recurrent_phase(torch, lm_counters)
    emit(rec)
    _phase_start(torch, "lm_frontends")
    front = lm_frontends_phase(torch, lm_counters)
    emit(front)
    _phase_start(torch, "lm_dense12b")
    dense = lm_dense12b_phase(torch, lm_counters)
    emit(dense)
    _phase_start(torch, "train_dist")
    dist_ = train_dist_phase(torch)
    emit(dist_)
    _phase_start(torch, "dryrun")
    dry = dryrun_phase(torch, gnn_counters)
    emit(dry)
    _phase_start(torch, "end")
    emit({"phase": "memory", "at_phase_start": MEMORY})
    # #1 on each training path's own embedding cotangent, at its shape
    ss2 = lmt.pop("segment_sum_2d")
    ss2["checks_by_path"] = {
        "train": train["embed_grad"],
        "train_pipeline": pipe["mtl_all"]["grad_vs_plain"]["embed_grad"],
        "gnn_bf16": gnn16["train"]["grad_vs_plain"]["embed_grad"],
        "finetune": fine["embed_grad"],
        "lm_train": lmt["lm"]["embed_grad"],
        **{f"lm_moe {name}": r["train"]["embed_grad"]
           for name, r in moe["configs"].items()},
        **{f"lm_recurrent {name}": r["train"]["embed_grad"]
           for name, r in rec["configs"].items()},
        **{f"lm_frontends {name}": r["train"]["embed_grad"]
           for name, r in front["configs"].items()},
        **{f"lm_dense12b {name}": r["train"]["embed_grad"]
           for name, r in dense["configs"].items()}}
    ss2["by_shape"] = {
        **{f"lm_moe {name}": r["train"]["segment_sum_2d"]
           for name, r in moe["configs"].items()},
        **{f"lm_recurrent {name}": r["train"]["segment_sum_2d"]
           for name, r in rec["configs"].items()},
        **{f"lm_frontends {name}": r["train"]["segment_sum_2d"]
           for name, r in front["configs"].items()},
        **{f"lm_dense12b {name}": r["train"]["segment_sum_2d"]
           for name, r in dense["configs"].items()}}
    ss2["max_abs_err"] = max(c[c["dtype"]]["max_abs_err"]
                             for c in ss2["checks_by_path"].values())
    emit({"phase": "kernel", "name": "segment_sum_2d", "tolerance": {
        "vs_token_order_sum": "bitwise", "vs_one_hot": "2 n u sum|g| "
        "(+ 2^-7 |ref| in bf16)"}, **ss2})
    # each path's counts, zeroed just before it: serving (fused and pallas
    # passes), serving scale-out (runs (a) and (d)), training, the
    # pre-training pipeline (runs (a) and (b)), the task-parallel runs
    # (every rank of (a)-(c)), the bf16 GNN path (its serving passes and
    # its training run), fine-tuning (pre-training, both fine-tuning runs
    # and the accum=2 step), LM serving (runs (a) and (b)), LM training
    # (runs (a) and (b)), the MoE family and the recurrent family (each
    # config's serving runs and training runs). #1 takes every embedding's
    # backward: the species embedding's on the GNN training paths, the
    # token embedding's on the LM training paths
    lm_runs = (lm["run_a"]["launches"], lm["run_b"]["launches"])
    s16, t16 = gnn16["serve"], gnn16["train"]["launches"]
    by_path = {
        "segment_sum": {"serve": serve["pallas"]["launches"]["segment_sum"],
                        "serve_scaleout":
                        scaleout["launches"]["segment_sum"],
                        "gnn_bf16": s16["pallas"]["launches"]["segment_sum"],
                        "train_replay": sum(
                            r["launches"]["segment_sum"]
                            for r in train["replay"].values())},
        "egnn_edge_fused": {"serve": serve["fused"]["launches"]["egnn_edge"],
                            "serve_scaleout":
                            scaleout["launches"]["egnn_edge"],
                            "train": train["launches"]["egnn_edge"],
                            "train_pipeline": pipe["launches"]["egnn_edge"],
                            "analysis": analysis["launches"]["egnn_edge"],
                            "train_mtp": mtp["launches"]["egnn_edge"],
                            "finetune":
                            fine["pretrain"]["launches"]["egnn_edge"]
                            + fine["launches"]["egnn_edge"],
                            "train_dist": dist_["launches"]["egnn_edge"],
                            "dryrun": dry["launches"]["egnn_edge"]},
        "egnn_edge_fused_bwd": {
            "train": train["launches"]["egnn_edge_bwd"],
            "train_pipeline": pipe["launches"]["egnn_edge_bwd"],
            "analysis": analysis["launches"]["egnn_edge_bwd"],
            "train_mtp": mtp["launches"]["egnn_edge_bwd"],
            "finetune": fine["pretrain"]["launches"]["egnn_edge_bwd"]
            + fine["launches"]["egnn_edge_bwd"],
            "train_dist": dist_["launches"]["egnn_edge_bwd"],
            "dryrun": dry["launches"]["egnn_edge_bwd"]},
        "egnn_edge_fused_bf16": {
            "gnn_bf16": s16["fused"]["launches"]["egnn_edge_bf16"]
            + t16["egnn_edge_bf16"]},
        "egnn_edge_fused_bwd_bf16": {"gnn_bf16": t16["egnn_edge_bwd_bf16"]},
        "segment_sum_2d": {
            "train": train["launches"]["segment_sum_2d"],
            "train_pipeline": pipe["launches"]["segment_sum_2d"],
            "analysis": analysis["launches"]["segment_sum_2d"],
            "train_mtp": mtp["launches"]["segment_sum_2d"],
            "gnn_bf16": t16["segment_sum_2d"],
            "finetune": fine["pretrain"]["launches"]["segment_sum_2d"]
            + fine["launches"]["segment_sum_2d"],
            "lm_train": lmt["launches"]["segment_sum_2d"],
            "lm_moe": moe["launches"]["segment_sum_2d"],
            "lm_recurrent": rec["launches"]["segment_sum_2d"],
            "lm_frontends": front["launches"]["segment_sum_2d"],
            "lm_dense12b": dense["launches"]["segment_sum_2d"],
            "train_dist": dist_["launches"]["segment_sum_2d"],
            "dryrun": dry["launches"]["segment_sum_2d"]},
        "flash_attention": {"lm_serve": sum(r["flash_attention"]
                                            for r in lm_runs),
                            "lm_moe": moe["launches"]["flash_attention"],
                            "lm_recurrent":
                            rec["launches"]["flash_attention"],
                            "lm_frontends":
                            front["launches"]["flash_attention"],
                            "lm_dense12b":
                            dense["launches"]["flash_attention"],
                            "train_dist": dist_["launches"]["flash_attention"]},
        "flash_decode": {"lm_serve": sum(r["flash_decode"]
                                         for r in lm_runs),
                         "lm_moe": moe["launches"]["flash_decode"],
                         "lm_recurrent": rec["launches"]["flash_decode"],
                         "lm_frontends": front["launches"]["flash_decode"],
                         "lm_dense12b": dense["launches"]["flash_decode"],
                         "train_dist": dist_["launches"]["flash_decode"]}}
    launches = {k: sum(v.values()) for k, v in by_path.items()}
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    kernels = [
        {"name": "segment_sum_2d", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": "src/repro/kernels/segment_sum/kernel.py:136",
         "launches": launches["segment_sum_2d"], **ss2},
        {"name": "segment_sum", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": "src/repro/kernels/segment_sum/kernel.py:183",
         "launches": launches["segment_sum"], **ss},
        {"name": "egnn_edge_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:156",
         "launches": launches["egnn_edge_fused"], **eg},
        {"name": "egnn_edge_fused_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge_bwd.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:319",
         "launches": launches["egnn_edge_fused_bwd"], **eb},
        {"name": "egnn_edge_fused_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:156",
         "launches": launches["egnn_edge_fused_bf16"], **eg16},
        {"name": "egnn_edge_fused_bwd_bf16", "route": "cuda",
         "source": "src/repro_torch/csrc/egnn_edge_bwd.cu",
         "replaces": "src/repro/kernels/egnn_edge/kernel.py:319",
         "launches": launches["egnn_edge_fused_bwd_bf16"], **eb16},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:102",
         "launches": launches["flash_attention"], **fa},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/kernel.py:113",
         "launches": launches["flash_decode"], **fd},
    ]
    emit({"kernels": [dict({k: kern[k] for k in
                            ("name", "route", "source", "replaces") + keys},
                           launches_by_path=by_path[kern["name"]])
                      for kern in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
