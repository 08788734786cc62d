#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each prints one JSON object per line; any failed check raises and
the script exits non-zero without printing a result):

0. the card: name and power limit, TF32 off;
1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
   process per source) and print their ``-Xptxas -v`` report;
2. each kernel at the main path's shapes, held bitwise against its plain
   PyTorch version and timed with CUDA events beside its plain version, its
   bound and, where one exists, a single PyTorch call that computes the
   same function; ``beam_merge`` also at L = 2048 (the paper's degree
   256 + 256 at W = 4), bitwise, its time and bound under ``paper_degree``;
3. the main path at full size: ``make_corpus`` (n = 1,000,000, d = 128,
   SIFT1M's size and width) → ``UGIndex.build`` with the build CLI's
   defaults → ``UGIndex.search_mixed`` over 10,000 queries cycling
   IF/IS/RS/RF at ef = 64, k = 10, W = 4, timed over several batches;
   recall@10 against the port's exact ``brute_force``, for those queries
   (``make_queries`` draws their cluster centres apart from the corpus's, as
   the reference does) at ef = 64 and at wider beams, and for queries drawn
   around corpus rows;
4. path checks: every kernel of the f32 path launched during phase 3; the
   kernel path equals the plain path bitwise for search and for a
   50,000-row build; a mixed batch equals four per-semantics batches;
   recall tripwires (a broken graph or kernel gives ~0): mean recall@10
   ≥ 0.2 over the four semantics on the 50,000-row index, where this
   synthetic workload still allows it, and ≥ 0.02 on the 1M index (chance
   is ~1e-5 there); the 50,000-row index's recall beside that of an
   exact-KNN (``exact_spatial``) build of the same corpus;
5. the quantized path at full width: phase 3's 1M index re-encoded with
   ``UGIndex.with_dtype`` to a bf16 plane (no rerank), an int8 plane and a
   pq plane (both with the f32 rerank plane), the same graph; for each,
   bytes, encode (and pq training) time, QPS over the same 10,000 mixed
   queries, recall@10 against phase 3's exact truth, launches of its
   kernels (counted from 0 over its warm-up and timed batches); checks on
   1,000 queries (``backend="cuda"`` equals ``"torch"`` bitwise, the mixed
   batch equals four per-semantics batches) and a tripwire on the
   50,000-row index: mean recall@10 ≥ half of the f32 plane's;
6. the paper-table bench path at full width, on phase 3's corpus, config
   and index: (a) ``pairwise_sq_dist`` at 10,000 queries × 65,536 corpus
   rows × 128, f32 and bf16, within its stated bound of its plain version
   (``|kernel − plain| ≤ (d + 4)·2⁻²³·(‖q‖² + ‖x‖²)``: the product runs on
   the tensor cores, 3×TF32 for f32) with the largest error over the norms
   printed, and bitwise on integer data at 1,000 × 8,192 × 128; bf16 and
   ``torch.cdist`` timed; (b) ``filtered_topk`` (k = 10, IF and IS,
   uniform windows; its product also runs on the tensor cores) within its
   stated rule of its plain version (``fused_scan.rule_violations``) on
   1,000 queries against the whole 1M corpus and at a ragged small shape
   (77 × 3,001, k ∈ {1, 64}), bitwise on integer data at 1,000 × 65,536 ×
   128, f32 and bf16; its bf16 entry and ``brute_force`` timed on all
   10,000 queries; (c) the scan against ``prefilter_search``
   on those 1,000 queries; (d) Exp-1 and Exp-4 through ``repro_torch.bench``
   (post-filter and Hi-PNG builds at 1M, IF search of the 10,000 queries,
   the kernel table at these shapes, whose rows give both kernels' times:
   each kernel on all 10,000 queries, the plain scan on the first 1,000)
   with its launches counted from 0, and tripwires: every post-filter and
   Hi-PNG answer passes the predicate, the pre-filter's recall is 1, the
   post-filter's ``backend="cuda"`` equals ``"torch"``; (e) ``build_exact``
   at n = 1,000: prune backends cuda and torch give the same graph, and one
   structural-heredity check (Thm 3.5) holds;
7. streaming updates at full width on the kernels: (a) 10 % churn of phase
   4's 50,000-row index (5,000 random live ids deleted with repair, then
   5,000 new rows from the corpus's own mixture inserted, as the
   reference's churn contract draws them): ``backend="cuda"`` equals
   ``"torch"`` bitwise on every store array after the delete and after the
   insert, no deleted id surfaces, the capacity is unchanged (slots
   reused), recall@10 per semantics at ef = 64 over 1,000 queries a
   semantics is at least that of a fresh build of the same live set minus
   0.02, and ``compact()`` gives the same answer sets after id remapping;
   beside it, measured and not held to a bar, the same churn with 5,000
   rows of ``make_corpus`` with another seed (new cluster centres, which
   one batch of mutually invisible rows cannot wire among themselves)
   against its own fresh build;
   (b) 1 % churn of phase 3's 1M index (10,000 ids deleted with repair,
   10,000 rows of the corpus's mixture in one ``insert_batch``), the
   delete, insert and compact
   timed, the touched rows, repair blocks and offer rounds (and their
   seconds) printed with the
   launches of ``prune_sweep``, ``expand_score`` and ``beam_merge`` over
   the delete and insert (counted from 0), then QPS, iterations and
   recall@10 of the 10,000 mixed queries against ``brute_force`` over the
   live rows; tripwires: mean recall@10 ≥ 0.02, no deleted id surfaces,
   capacity unchanged; (c) 1,000 rows inserted into phase 3's index
   re-encoded as int8 + rerank and as pq + rerank: ``cuda`` equals
   ``torch`` bitwise;
8. serving at full width on phase 3's index (which phase 7's functional
   updates left as it was): (a) ``ServeEngine.retrieve_mixed`` of phase 3's
   10,000 mixed queries, padded to the 10,240 bucket, bitwise phase 3's
   ``search_mixed`` (ids, distances, steps, iterations), the attached
   store's buffers kept, its launches printed; then, outside every count,
   the padded and the unpadded batch timed in turns, and the QPS of the
   same requests as sync batches of 256 and through a
   runtime whose queue holds them all before its threads start; (b) the
   threaded ``ServeRuntime`` (micro-batches of up to 256) answering the
   same 10,000 queries as single-row requests with deadlines from a
   closed-loop client that keeps 512 requests in flight, a remove of 1,000
   live ids with repair and an upsert of 1,000 rows of the corpus's
   mixture submitted halfway: every reply bitwise a direct padded
   ``search_mixed`` on the snapshot it pinned, no removed document (a
   removed id still holding its old row; the upsert reuses the freed
   slots) and no dead slot in a reply after the write, nothing rejected,
   two writes, every tensor of the pre-write index unchanged; QPS, p50/p99
   over every reply's latency, the replies answered before the write and
   each write's seconds from its submission to its future's resolution
   printed; (c) ``bench_serve``
   (4,096 requests, micro-batches of 256) and ``bench_updates`` (1 %
   churn) on phase 3's corpus and index, their rows printed, the consistency
   rows at 1.000; (d) ``save_index`` → ``restore_index`` of (b)'s mutated
   index under ``build/`` (removed afterwards): every store tensor bitwise
   and a search of the 10,000 queries bitwise the live index's, save and
   restore seconds and bytes and the free disk space printed, and
   ``AsyncCheckpointer`` writing the same files; (e) the serve path's
   launches (the runtime's run (b), counted from 0): ``expand_score``,
   ``beam_merge`` and ``prune_sweep`` each above 0.
9. the row-sharded index (``core/sharded.py``) on the card, one process
   holding ``N_SHARDS`` shards, with a one-process NCCL group so that the
   NCCL collectives are called (a failure to start NCCL fails the phase):
   (a) ``build_sharded_store`` of phase 3's corpus with phase 3's
   ``UGConfig``, its seconds split into the ring bootstrap, the attribute
   candidates and the refinement, edges, columns, bytes and ``prune_sweep``
   launches; (b) the mixed sharded search of phase 3's 10,000 queries, QPS
   beside phase 3's and recall@10 per semantics against phase 3's exact
   truth (tripwire: mean ≥ 0.02); (c) checks: the sharded answer is bitwise
   the stable merge of the ``make_shard_probe_fns`` answers; on phase 4's
   50,000-row corpus (exact-KNN config) the build and search through the
   kernels equal the plain versions on the card bitwise, f32 and int8 +
   rerank; the device build's recall per semantics is at least the host
   build's (``build_sharded_index_host`` + ``shard_index``) minus 0.01; the
   ring KNN's neighbour sets of sampled rows are ``brute_force_knn``'s (up
   to ties at the k-th distance within f32 rounding); (d) ``SHARD_PROCS``
   spawned processes in a gloo group share the card, each holding
   ``N_SHARDS / SHARD_PROCS`` shards of (c)'s f32 index: their build, ring
   and search equal (c)'s one-process results bitwise; (e)
   ``FleetServeMonitor.probe`` over (a)'s probe functions, per-shard seconds
   and the report's plan; (f) the launches of ``SHARD_KERNELS`` over (a) and
   (b), each above 0.
10. the legacy A/B backends and the rest of the bench: (a) phase 3's
   10,000 mixed queries through the one-node-per-step ``legacy`` loop at
   ef = 64, QPS, iterations and recall@10 per semantics beside phase 3's
   fused numbers; on 50,000 integer-valued rows (columns spanning
   [-127, 127], so int8 dequantizes exactly) the legacy search on the card
   equals the same search of the same index on the CPU bitwise, on the f32
   plane and on int8 + rerank with 5 % of the rows tombstoned; (b)
   ``bench_build`` at the reference's sizes (1,000, 2,000 and 4,000 rows,
   d = 24): the ``legacy``, ``torch`` and ``cuda`` sweeps build graphs with
   equal checksums, the legacy sweep's profiled peak bytes beside the
   fused sweeps', and the sharded pq build; (c) ``bench_beam_sweep``,
   ``bench_mixed_workload`` and ``bench_memory`` on phase 3's index and
   queries, ``bench_scalability`` at 10,000, 100,000 and phase 3's
   1,000,000 rows (d = 128), ``bench_sensitivity`` at the reference's 2,000
   rows, their rows printed, and the launches of (a)'s check, (b) and (c),
   each kernel of ``LEGACY_BENCH_KERNELS`` above 0; (d) ``python -m
   repro_torch.bench.run --smoke --check`` against the baseline the CPU
   wrote, in a subprocess on the card: it must exit 0, and every recall that
   differs from the CPU's is printed with both values.
11. the LM towers (``models/``, ``configs/``, ``ServeEngine.embed``/
   ``generate``, the serve CLI): (a) the five dense archs' reduced towers
   (float32) on the card and on the CPU with the same weights, hidden
   states, embeddings and 12 decode steps' logits within atol = rtol =
   1e-4, the largest errors printed; (b) qwen1.5-4b at full width (40
   layers, d = 2560, vocab 151,936, bf16) from a seeded generator, its
   parameter count 3,950,369,280, ``embed`` of 50,000 documents of 32
   random tokens in batches of 256: seconds, tokens/s and TFLOP/s (2 × the
   parameters outside ``embed``/``unembed`` × tokens over the seconds)
   beside the bf16 peak, every embedding finite and of unit norm within
   1e-5; (c) ``UGIndex.build`` of the 50,000 × 2560 embeddings with the
   serve CLI's ``UGConfig`` (NN-descent) and uniform intervals, the mixed
   search of 10,000 embedded queries cycling IF/IS/RS/RF at ef 64, k 10,
   W 4: QPS (median of 3, with min and max), iterations, recall@10 per
   semantics against ``brute_force``
   (tripwire: mean ≥ 0.02), and on the first 5,000 documents the build
   and the search with ``cuda`` equal to ``torch`` bitwise; (d) 4 prompts
   × 16 tokens through ``decode_step`` against ``prefill`` + ``unembed``:
   the first position's logits within 2⁻⁵ relative RMS, the second's
   within 0.15 and the decode cache's layer 0 within 2⁻⁶ of the
   prefill's, every position's error
   printed (the reasons stand in the code); (e) greedy ``generate`` of 16
   tokens for 8 prompts of 16, seconds and tokens/s; (f) ``python -m
   repro_torch.launch.serve --arch qwen1.5-4b --no-reduced --docs 2000
   --queries 64 --mixed`` in a subprocess on the card: exit 0, its lines
   printed; (g) the launches of ``expand_score``, ``beam_merge`` and
   ``prune_sweep`` over (c)'s build and timed searches (before its checks),
   each above 0.
12. the other tower families (``models/moe``, ``ssm``, ``rwkv_model``,
   ``zamba``, ``encdec``): (a) the reduced qwen3-moe, llama4-maverick,
   rwkv6, zamba2 and seamless-m4t-medium towers (float32, TF32 off) on the
   card and on the CPU with the same weights, the leaves the init makes
   constant redrawn as in the CPU tests: hidden states, MoE aux,
   embeddings (encdec: ``encode`` and ``decode_train``) and 12 decode
   steps' logits within atol = rtol = 1e-4, the MoE towers' expert choices
   equal, the smallest top-k margin printed; (b) rwkv6-1.6b and
   zamba2-2.7b whole, qwen3-moe-235b-a22b at full width with 6 layers and
   llama4-maverick-400b-a17b at full width with 2 (the cuts and their
   memory arithmetic printed), bf16 from a seeded generator: parameter
   and active-parameter counts equal to the CPU's, ``embed`` of 8,192
   documents of 32 tokens in batches of 256 (seconds, tokens/s, peak
   memory, TFLOP/s over 2 × the active parameters outside
   ``embed``/``unembed``), every embedding finite and of unit norm within
   1e-5; (c) 4 prompts × 16 tokens through ``decode_step`` against
   ``prefill`` + ``unembed``: rwkv6 and zamba2 in bf16 and in float32 on
   the same weights upcast, positions 0 and 1 held (the bounds and their
   reasons at ``decode_checks``), the MoE towers printed with both sides'
   dropped assignments and held to nothing (the capacity depends on the
   call's tokens); and seamless-m4t-medium at full width, 8 × 64 seeded
   frames encoded, 16 ``decode_step``s against ``decode_train``, held as
   rwkv6; (d) greedy
   ``generate`` of 16 tokens for 8 prompts of 16 on the four towers of (b);
   (e) ``UGIndex.build`` over qwen3-moe's 8,192 embeddings (d = 4096)
   with the serve CLI's ``UGConfig``, a mixed search of 2,000 embedded
   queries cycling IF/IS/RS/RF at ef 64, k 10, W 4: QPS (median of 3),
   iterations, recall@10 per semantics against ``brute_force`` (tripwire:
   mean ≥ 0.02), on the first 4,096 rows the build and the search with
   ``cuda`` equal to ``torch`` bitwise, and the launches of
   ``expand_score``, ``beam_merge`` and ``prune_sweep`` over the build and
   timed searches, each above 0; (f) ``python -m repro_torch.launch.serve
   --arch A --no-reduced --docs 2000 --queries 64 --mixed`` in a subprocess
   on the card for rwkv6-1.6b and zamba2-2.7b: exit 0, its lines printed.

13. training on the card (``train/``, the four families' losses with
   remat, ``data``'s LM batches, ``launch/train``, ``bench_lm_steps``), in
   PyTorch's deterministic mode (``train/step.py::deterministic``; the
   backward's float scatter-adds would otherwise be atomics): (a) the ten
   reduced archs (float32, TF32 off) with the same weights and
   ``lm_batch`` (B = 2, S = 32; encoder frames for encdec) on the card and
   on the CPU: ``Model.loss``, ``ce`` and ``aux`` within 1e-4 relative,
   every gradient leaf within 1e-4 of that leaf's largest CPU magnitude,
   and the parameters after one ``make_train_step`` within 1e-5 under
   ``AdamWConfig(eps=1e-3)`` (Adam's first step is ``lr · sign(g)`` where
   ``|g| ≫ eps``, so a near-zero gradient whose sign differs by rounding
   moves its parameter by 2·lr; eps = 1e-3 makes the update smooth in
   ``g``), the MoE archs' expert choices equal and their smallest top-k
   margin printed; RWKV6's decay base and LoRA drawn as N(−1, 0.5²) and
   N(0, 0.1²) (``TRAIN_DECAY``: with the forward phases' N(0, 4²) base the
   gradient through the log decay is float32 noise, see
   ``tests/test_torch_grads_recurrent.py``); (b) two 6-step runs of
   reduced qwen1.5-4b, qwen3-moe, rwkv6 and zamba2 bitwise equal; the CLI
   drill (``launch.train.main`` in this process): ``--arch qwen3-moe-235b-a22b
   --reduced --steps 6 --ckpt-every 3 --batch 4 --seq 32 --ckpt-dir D1``,
   its final checkpoint moved to ``D2`` (what is left is a run preempted
   after step 3 of a 6-step schedule), then the same with ``--resume``,
   which must print ``resumed at step 3``, its final checkpoint's array
   files byte for byte those of the straight run in ``D2`` (and the same
   keys and cursor); microbatches 2
   against 1 on reduced qwen1.5-4b within the reference's 2e-5 (eps rule);
   reduced qwen1.5-4b 30 steps on one fixed batch from the CPU's weights,
   its last loss below ``LEARN_BAR`` (set from a CPU run, printed);
   (c) qwen1.5-4b whole at full width (bf16 from a seeded generator,
   float32 moments), B = 4, S = 512, 8 donated steps with ``launch/train``'s
   schedule: each step's loss, grad norm, lr and ms, tokens/s, peak memory,
   and model TFLOP/s (6 × its 3,561,413,120 parameters outside the embed
   lookup × tokens/s; remat runs each block's forward twice) beside the
   989 TFLOP/s bf16 peak; the cut and its memory arithmetic printed
   (``TRAIN_CUTS``); every loss and grad norm finite, the parameters
   changed; (f), run next while (c)'s parameters are on the card: the
   trained tower's ``ServeEngine.embed`` of 4,096 documents × 32 tokens
   (finite, unit norm within 1e-5), ``UGIndex.build`` with the serve CLI's
   ``UGConfig``, ``prune_backend`` cuda bitwise torch, a mixed search of
   1,000 embedded queries at ef 64, k 10, W 4: QPS, iterations, recall@10
   per semantics against ``brute_force`` (tripwire: mean ≥ 0.02), and the
   launches of ``expand_score``, ``beam_merge`` and ``prune_sweep`` over
   the build and the searches, counted from 0, each above 0
   (``launches_training`` in the kernels line); (d) rwkv6-1.6b whole, 4
   steps at B = 4, S = 512 (4 chunks of 128), the same prints and checks;
   (e) qwen3-moe-235b-a22b at full width with 1 layer (~3.73 B parameters
   at 12 bytes each, 44.8 GB, plus a 3.2 GB float32 init temporary; two
   layers would take ~75 GB), 2 steps at B = 2, S = 256, the same, and
   the dropped assignments of each router call; (g) ``python -m
   repro_torch.bench.run --only lm_steps`` in a subprocess on the card:
   exit 0 and its three rows.

14. the mesh half of training (``launch/shardings``, ``models/shard_ctx``,
   the mesh train step, the MoE's global dispatch and expert-parallel path,
   ``ckpt`` with shardings, ``ft.elastic.resume``, ``launch/train --mesh``)
   in PyTorch's deterministic mode: (a) one process holding every shard of
   a (2, 2) ("data", "model") mesh: the ten reduced archs (float32, TF32
   off) take 2 mesh steps from the weights and masked ``lm_batch`` batches a
   one-device ``make_train_step`` takes: the parameters after the first
   step within a tenth of 13(a)'s gradient bound of their kind (1e-5
   dense, 1e-4 MoE, recurrent and encdec) under ``AdamWConfig(eps=1e-3)``,
   after the second within that gradient bound (the two runs
   then start from parameters that differ by rounding, which the reduced
   towers amplify), every block of the shape its spec gives, the MoE
   archs' first-step ce and aux within 1e-6 relative and their dropped
   assignments equal at every step; (b) ``shard_ctx.use_mesh`` on (2, 2) for reduced
   qwen3-moe's and llama4's MoE layer: at capacity factor 16 the
   expert-parallel output and input gradient within 1e-4 of the local
   path's, at the config's capacity both paths' drops printed; (c) two
   gloo processes share the card on (2, 2), (2, 1) and (1, 2) meshes:
   reduced qwen1.5-4b and qwen3-moe's parameters after (a)'s steps
   bitwise one process's on the same mesh ((a)'s on (2, 2)), and (b)'s EP
   outputs and gradients bitwise; (d) rwkv6-1.6b whole in 2 gloo
   processes on (2, 1), B = 4, S = 512, 3 steps: each process's peak
   memory and held bytes (half the one-device bytes), ms a step split
   into compute and collectives, tokens/s, loss and grad norm finite, the
   parameters changed and, gathered, bitwise a one-process (2, 1) run;
   qwen3-moe-235b-a22b's EP layer at full width (d 4096, 128 experts,
   top-8) in 2 processes on (1, 2), forward and backward of B = 2,
   S = 256, bitwise one process holding both shards, its ms and the bytes
   its all-to-alls sent; (e) the trained rwkv6 (from (d)'s one-process
   run) embeds, indexes and serves as 13(f) does, ``launches_mesh`` in
   the kernels line; (f) ``launch.train.main`` in this process: reduced
   qwen3-moe ``--mesh 2x2 --steps 6 --ckpt-every 3``, its final
   checkpoint moved away, then ``--resume --mesh 1x2``: ``resumed at step
   3``, the final parameters within 1e-5 of the straight run's;
15. the dry-run (``launch/dryrun.py``, ``hlo_analysis.py``, ``roofline.py``):
   (a) ``python -m repro_torch.launch.dryrun --mesh single`` in three
   subprocesses side by side, for qwen1.5-4b ``train_4k``, qwen3-moe
   ``decode_32k`` (both counted on ``meta`` as one card of the 16×16 mesh
   runs them; the decode cell is the split serve step of phase 19, a
   card's heads, experts, vocab columns and sequence block of the cache)
   and ``--index-cell`` (one real step of one shard on the
   card); each exits 0 and its record and roofline row are printed;
   (b) 13(c)'s cell (qwen1.5-4b whole, B = 4, S = 512) counted on a (1, 1)
   mesh: its compute, memory and collective terms beside 13(c)'s measured
   median step and peak memory (the stand-in for a compiler's temp
   bytes), the bound's and 6 N D's fractions of the measured step;
   (c) the plan's collective bytes a process for 14(d)'s rwkv6 (2, 1)
   step, equal to what each rank's collectives counted, beside 14(d)'s
   measured collective seconds (an achieved GB/s); (d) the index cell's
   step on the card, launches counted from 0 (``launches_dryrun`` in the
   kernels line, each above 0), its tally equal to the plain versions'
   on the CPU on the same inputs and its ids and distances bitwise
   theirs (the two kernels' results at the cell's d = 768).

16. tensor parallelism in the mesh train step (``models/shard_ctx``'s
   ``enter``/``leave``, the split products of ``common.swiglu``,
   ``transformer`` and ``attention``, ``collectives.ordered_sum``,
   ``train/step.py::_MeshStep``), in PyTorch's deterministic mode:
   qwen3-32b at full width (d = 5,120, 64 heads, 8 kv heads, d_ff 25,600,
   vocab 151,936) cut to 2 of its 64 layers (``TRAIN_CUTS``), on a (1, 2)
   mesh in two gloo processes sharing the card, each computing its model
   shard's heads, MLP columns and vocab rows
   (``launch/sharded.py::tp_check_rank``), at B = 2, S = 256: 2 float32
   steps, then 1 step in the config's bf16.  Each is held to a one-device
   step on the same weights and batch (run after the mesh steps, in each
   process in turn, in bf16 in the first process alone): step 1's loss and
   grad norm within ``TP_METRIC_TOL`` relative
   (1e-6 in float32, 2^-8 in bf16), and in float32 each process's
   parameters after step 1 within ``TP_PARAM_TOL`` (1e-6) and its peak
   memory over the step at most ``TP_PEAK_RATIO`` of the one-device
   step's (the bf16 ratio is reported); each step's seconds and its
   ``gather_s``/``tp_s``/``reduce_s``, loss and grad norm finite and
   equal on both processes, and the collective bytes each process counted
   equal to ``mesh_step_collectives``'s plan in both dtypes.  The
   products are ``torch.matmul`` (the reference's run outside any Pallas
   kernel), so this path launches no kernel of the kernels line.
17. tensor parallelism for the MoE archs (``models/moe.py``'s split
   global dispatch: the routing whole, once a process; each ``model``
   shard's ``E / 2`` experts' dispatch rows, products and combine; the
   partials summed over ``model`` in shard order): qwen3-moe-235b-a22b
   at full width (d 4,096, 64 heads on 4 kv heads, 128 experts, top-8,
   expert d_ff 1,536, vocab 151,936) cut to 1 of its 94 layers, float32,
   B = 2, S = 256.  The one-device step runs first, alone in this process
   (``launch/sharded.py::tp_reference``: params, moments and gradients
   ~60 GB, more than fits beside the two processes), and keeps on the
   host its loss, grad norm, aux, dropped assignments and the parameters
   after it: every leaf whole but the experts and the vocab leaves, which
   it keeps at the first and last expert (row) of each model shard.  Then
   two gloo processes on (1, 2), forked from the server, each take 2
   donated steps (``tp_check_rank``): step 1's parameters within
   ``TP_PARAM_TOL`` (1e-6) of the kept ones, its loss and grad norm
   within 1e-6 relative, its dropped assignments equal, the two processes
   equal, the collective bytes each counted equal to the plan; each
   process's peak over the one-device step's, its ``gather_s``, ``tp_s``
   and ``reduce_s`` printed.  It launches no kernel of the kernels line.

18. tensor parallelism for rwkv6, zamba2 and encdec
   (``rwkv_model``/``zamba``/``encdec``'s ``tp_groups``, planned by
   ``shard_ctx.plan_groups``): rwkv6-1.6b at full width cut to 2 of its
   24 layers (each model shard's 16 time-mix heads with their ``w_g``
   columns, its channel-mix columns and vocab rows; ``w_ffn_r`` whole),
   zamba2-2.7b at full width cut to one period (6 Mamba layers, each
   shard's 40 Mamba heads, their ``w_in``/``conv_w`` columns read from
   the gathered leaves and the gated norm's sums over ``model``, and one
   site of the shared block, its heads and MLP columns split), and
   seamless-m4t-medium at full width cut to 2 encoder and 2 decoder
   layers (encoder, decoder and cross attention heads, MLP columns, its
   vocab rows 2 ways; ``frame_proj`` whole; 256 seeded frames), B = 2,
   S = 256 (``FAMILY_TP_CUTS``), each in float32 and zamba2 and
   seamless-m4t in float64 too (``FAMILY_TP_FULL``).  Each run's
   one-device step runs first, alone in this process, then two gloo
   processes on (1, 2), forked from the server, take the donated steps of
   each cell's runs in turn (``launch/sharded.py::tp_check_all``): step
   1's parameters, loss and grad norm within ``FAMILY_TP_TOL`` of the
   one-device step's (in float64 the parameters and loss within 1e-6;
   rwkv6's in float32 too; the other float32 bounds 1.3-3 times the
   largest distance over four seeds, where a one-device step from
   weights moved by one rounding lies as far; seamless-m4t's float32
   parameters are held in float64 only), the two processes equal, the
   collective bytes each counted equal to the plan; each process's peak
   over the one-device step's, its ``gather_s``, ``tp_s`` and
   ``reduce_s`` printed.  It launches no kernel of the kernels line.

19. the decoders' split prefill and decode (``launch/dryrun.py``'s
   ``prefill_step`` and ``serve_step``: each ``model`` shard's heads, MLP
   columns, experts and vocab columns, its block of the KV cache, the
   sequence-split cache's partial softmaxes merged in shard order, the
   next token the argmax over the split vocab), float32, B = 2, a prompt
   of 240 in a cache of 256 (the rows' lengths 240 and 229), then 16
   teacher-forced decode steps (``SERVE_TP_FULL``): qwen3-32b at full
   width cut to 2 of its 64 layers on (1, 2) (its 8 kv heads split) and on
   (1, 16) in two processes of 8 model shards each (8 kv heads on 16: the
   cache split by its sequence, 16 positions a shard); minicpm3-4b cut to
   2 of 62 layers on (1, 2) (MLA's latent cache, split by its sequence);
   qwen3-moe-235b-a22b cut to 1 of 94 layers on (1, 2) (64 experts a
   process).  Each cell's one-device prefill and decode run first, alone
   in this process, then the same split with both shards in this process,
   then two gloo processes forked from the server run every cell
   (``launch/sharded.py::serve_check_all``).  Checks: the prefill's
   logits and caches, each step's logits and the last caches within
   ``SERVE_TP_TOL`` of the one-device run's (3 times the largest distance
   of a one-device run from weights moved by 2^-24 over four seeds,
   ``python -m repro_torch.bench.split_rounding --serve``), the next
   tokens equal, every process's blocks bitwise the one-process run's, and
   each process's collective bytes, call by call, equal to
   ``hlo_analysis.serve_step_collectives``'s plan.  It prints the ms of
   the prefill and of a decode step with their ``tp_s`` (the model-axis
   collectives over gloo) and each process's peak memory against the
   one-device run's.  It launches no kernel of the kernels line.

Before the last lines the script checks that no process it started (the
compiler, the spawned ranks, multiprocessing's resource tracker) is still
running; the line before the kernels line gives the run's seconds and each
phase's.  The last line is ``{"ok": true, "device": {...}}``.  Nothing here imports
JAX or the reference package.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

# phase 13 trains in PyTorch's deterministic mode, whose cuBLAS needs this
# workspace setting before the process's first product
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = pathlib.Path(__file__).resolve().parent
N_MAIN = 1_000_000             # corpus rows of the main path (SIFT1M's size)
N_CHECK = 50_000               # corpus rows of the build-parity check
N_QUERIES = 10_000
PER_SEM = 1_000                # queries per semantics that recall is scored on
SEARCH = dict(ef=64, k=10, width=4)
WIDE_EFS = (128, 256, 1024)    # wider beams over the same queries
TIMED_BATCHES = 5
PQ_M = 16                      # pq subspaces at d = 128 (default_pq_m)
# The kernels each path launches; phase 3 runs the f32 path, phase 5 the rest.
PATH_KERNELS = {
    "f32": ("prune_sweep", "expand_score", "beam_merge"),
    "bf16": ("expand_score_bf16", "beam_merge"),
    "int8": ("expand_score_q", "expand_score", "beam_merge"),
    "pq": ("expand_score_pq", "expand_score", "beam_merge"),
}
PLANES = (("bf16", False), ("int8", True), ("pq", True))   # (tag, rerank)
PATH_KERNELS["bench"] = ("pairwise_sq_dist", "filtered_topk")  # phase 6
N_L2 = 65_536                  # corpus rows of the pairwise matrix (all 1M rows: 40 GB out)
N_PLAIN = 1_000                # queries the plain filtered_topk is checked and timed on
K_SCAN = 10
N_EXACT = 1_000                # rows of the build_exact check
N_CHURN_50K = 5_000            # phase 7(a): 10 % of phase 4's 50,000 rows
N_CHURN_1M = 10_000            # phase 7(b): 1 % of phase 3's 1M rows
N_QUANT_INSERT = 1_000         # phase 7(c): rows inserted into the int8 and pq indexes
UPDATE_KERNELS = ("prune_sweep", "expand_score", "beam_merge")   # phase 7's path
N_SERVE_WRITE = 1_000          # phase 8(b): ids removed and rows upserted mid-stream
SERVE_MAX_BATCH = 256          # phase 8(b): the runtime's micro-batch cap
SERVE_IN_FLIGHT = 512          # phase 8(b): the closed-loop client's requests in flight
SERVE_BENCH = dict(nreq=4_096, batch=256, timed_seconds=0.0)    # phase 8(c): one round
SERVE_KERNELS = ("expand_score", "beam_merge", "prune_sweep")    # phase 8's path
N_SHARDS = 4                   # phase 9: shards of the sharded index, all held by one process
SHARD_KERNELS = ("prune_sweep", "expand_score", "beam_merge")    # phase 9's path
SHARD_PROCS = 2                # phase 9(d): processes sharing the card, 2 shards each
SHARD_RING_K = 10              # phase 9(c), (d): neighbours of the ring KNN
SHARD_RING_SAMPLE = 1_000      # phase 9(c): rows whose ring neighbours are checked
N_LEGACY_CHECK = 50_000        # phase 10(a): rows of the legacy card == CPU check
N_LEGACY_CHECK_QUERIES = 1_000
LEGACY_TIMED = 2               # phase 10(a): timed legacy batches at 1M (after one warm-up)
SCALE_SIZES = (10_000, 100_000, N_MAIN)                            # phase 10(c)
# phase 10's paths: (c)'s fused search rows, planes and builds, (a)'s rerank
LEGACY_BENCH_KERNELS = ("expand_score", "expand_score_bf16", "expand_score_q",
                        "expand_score_pq", "beam_merge", "prune_sweep")
SMOKE_GATE_TIMEOUT = 400       # phase 10(d): seconds the bench gate's subprocess may take
# phase 11: the LM towers embed the served corpus
TOWER_ARCH = "qwen1.5-4b"      # (b)-(f): the serve CLI's default arch at full width
TOWER_PARAMS = 3_950_369_280   # its parameter count
DENSE_ARCHS = ("chameleon-34b", "minicpm3-4b", "qwen1.5-4b", "qwen3-32b", "starcoder2-15b")
N_DOCS = 50_000                # (b), (c): documents embedded and indexed
DOC_LEN = 32                   # tokens a document or query (the serve CLI's --doc-len)
N_TOWER_CHECK = 5_000          # (c): documents of the cuda == torch build and search check
DECODE_CHECK = (4, 16)         # (d): prompts x tokens of decode against forward
GENERATE = dict(prompts=8, prompt_len=16, max_new=16)            # (e)
TOWER_KERNELS = ("expand_score", "beam_merge", "prune_sweep")    # (c)'s path
TOWER_CLI_TIMEOUT = 600        # (f): seconds the serve CLI's subprocess may take
# phase 12: the other tower families
FAMILY_REDUCED = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b", "rwkv6-1.6b",
                  "zamba2-2.7b", "seamless-m4t-medium")                # (a)
# (b)-(d): arch -> (layers it is cut to, or None; param_count; active_param_count),
# the counts tests/test_torch_{recurrent,moe}.py hold against the reference
FAMILY_TOWERS = {
    "rwkv6-1.6b": (None, 1_583_892_480, 1_583_892_480),
    "zamba2-2.7b": (None, 2_422_386_848, 2_422_386_848),
    "qwen3-moe-235b-a22b": (6, 16_171_193_856, 2_581_648_896),
    "llama4-maverick-400b-a17b": (2, 18_679_096_320, 2_698_798_080),
}
FAMILY_CUTS = {
    "qwen3-moe-235b-a22b": (
        "n_layers 94 -> 6 at full width: a layer is ~2.488 B parameters (2.416 B of them "
        "experts); 6 layers + embed/unembed are ~16.2 B (32.4 GB in bf16), and the init "
        "draws the stacked expert leaf (6, 128, 4096, 1536) in float32 whole, a 19.3 GB "
        "temporary: peak ~52 GB of 80 (8 layers: ~68 GB, no room for the dispatch)"),
    "llama4-maverick-400b-a17b": (
        "n_layers 48 -> 2 at full width: one super-layer, a dense block (d_ff 16384) and "
        "an MoE block (128 experts + the shared expert): ~18.7 B parameters (37.4 GB in "
        "bf16) plus a 21.5 GB float32 temporary for one expert leaf"),
}
N_FAMILY_DOCS = 8_192          # (b): documents each full-width tower embeds
INDEX_ARCH = "qwen3-moe-235b-a22b"   # (e): the tower whose embeddings (d = 4096) are indexed
N_FAMILY_QUERIES = 2_000       # (e): embedded queries of the mixed search
N_FAMILY_CHECK = 4_096         # (e): rows of the cuda == torch build and search check
FAMILY_DECODE = (4, 16)        # (c): prompts x tokens of decode against forward
ENCDEC_ARCH = "seamless-m4t-medium"
ENC_FRAMES = (8, 64)           # (c): batch x frames the encoder takes, at full width
FAMILY_CLI_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")                     # (f)
FAMILY_KERNELS = ("expand_score", "beam_merge", "prune_sweep")       # (e)'s path
# (c): relative RMS of decode against forward held at (position 0, position
# 1), by dtype and family, and below sqrt(2) over all positions (the
# reasons stand at decode_checks)
DECODE_TOL = {"bf16": {"rwkv6": (2 ** -5, 1.0), "zamba2": (2 ** -5, 1.0),
                       "encdec": (2 ** -5, 1.0)},
              "float32": {"rwkv6": (1e-3, 1e-3), "zamba2": (1e-3, 1e-3),
                          "encdec": (2 ** -5, 0.15)}}
# phase 13: training on the card
TRAIN_BATCH_REDUCED = (2, 32)  # (a): batch x tokens of the card == CPU check
TRAIN_EPS_RULE = dict(lr=1e-3, eps=1e-3, warmup_steps=2, total_steps=8)   # (a), (b)
# (a): |card - CPU| <= GRAD_TOL x the leaf's largest |CPU grad|, by kind of tower: the
# rule tests/test_torch_grads_*.py hold the port to the reference with.  The MoE and
# recurrent towers amplify float32 rounding (llama4's dense blocks attend near one-hot:
# the card read 2.2e-4 there, the CPU's two packages differ by up to 5.2e-4)
GRAD_TOL = {"dense": 1e-4, "moe_or_recurrent": 1e-3}
DETERMINISM_ARCHS = ("qwen1.5-4b", "qwen3-moe-235b-a22b", "rwkv6-1.6b", "zamba2-2.7b")  # (b)
DETERMINISM = dict(steps=6, batch=4, seq=32)                      # (b)
CLI_DRILL = dict(arch="qwen3-moe-235b-a22b", steps=6, ckpt_every=3, batch=4, seq=32)  # (b)
CLI_TIMEOUT = 300              # (g): seconds a training subprocess may take
LEARN = dict(arch="qwen1.5-4b", steps=30, batch=4, seq=32, seed=31)          # (b)
# (b): the loss after LEARN's 30 steps must be below this bar.  A CPU run of the
# port (same config, weights, batch and schedule) fell 6.9734 -> 3.9858; the bar
# keeps 83 % of that drop, leaving room for the card's other summation order
LEARN_BAR = 4.5
# (c)-(e): arch -> (layers it is cut to, or None; batch; seq; steps)
FULL_TRAIN = {
    "qwen1.5-4b": (None, 4, 512, 8),
    "rwkv6-1.6b": (None, 4, 512, 4),
    "qwen3-moe-235b-a22b": (1, 2, 256, 2),
}
TRAIN_MODEL_PARAMS = 3_561_413_120   # (c): qwen1.5-4b's parameters outside the embed lookup
TRAIN_CUTS = {
    "qwen1.5-4b": (
        "whole (40 layers) at B = 4, S = 512: 3,950,369,280 parameters; bf16 params 7.90 GB "
        "+ grads 7.90 GB + float32 moments 31.6 GB = 47.4 GB; a step that is not donated "
        "holds two copies of params and moments (~87 GB > 80 GB), so the step is donated; "
        "remat keeps the block inputs (40 x 2,048 x 2,560 x 2 B = 0.42 GB); one logits chunk "
        "(4 x 256 x 151,936 float32) 0.62 GB plus its gradient; the update's float32 "
        "temporaries bounded by its 64 M-element slices; predicted peak ~53 GB"),
    "rwkv6-1.6b": "whole (24 layers, d = 2048) at B = 4, S = 512 (4 chunks of 128)",
    "qwen3-32b": (
        "phase 16: n_layers 64 -> 2 at full width (d 5,120, 64 heads, 8 kv heads, d_ff "
        "25,600, vocab 151,936), float32, B = 2, S = 256: 2,531,026,432 parameters; one "
        "device holds params 10.1 GB + moments 20.2 GB + gradients 10.1 GB = ~40.5 GB, a "
        "process of (1, 2) its blocks (1,265,526,272 parameters, every leaf but the norms "
        "split) at 5.06 + 10.1 + 5.06 GB = ~20.2 GB; then one bf16 step of the same cell: "
        "one device bf16 params 5.06 + grads 5.06 + float32 moments 20.2 GB = ~30.4 GB, a "
        "process 2.53 + 2.53 + 10.1 GB plus its float32 gradient accumulator 5.06 GB = "
        "~20.2 GB"),
    "qwen3-moe-235b-a22b": (
        "n_layers 94 -> 1 at full width, B = 2, S = 256: a layer is ~2.488 B parameters "
        "and embed/unembed ~1.245 B, ~3.73 B at 12 bytes each (bf16 params and grads, "
        "float32 moments) = ~44.8 GB, plus the init's 3.2 GB float32 temporary of one "
        "(1, 128, 4096, 1536) expert leaf; two layers would take ~75 GB"),
}
TRAIN_SERVE = dict(docs=4_096, queries=1_000)    # (f): the trained tower embeds and serves
TRAIN_KERNELS = ("expand_score", "beam_merge", "prune_sweep")    # (f)'s path
# phase 14: the mesh half of training
MESH_SHAPE = (2, 2)            # (a), (b): ("data", "model"), one process holding every shard
MESH_STEPS = 2                 # (a), (c): steps from the same weights and batches
MESH_BATCH = (4, 32)           # (a), (c): batch x tokens; 80 % of the mask's positions kept
MESH_CHECK_ARCHS = ("qwen1.5-4b", "qwen3-moe-235b-a22b")             # (c)
# (a): |mesh - one device| on the parameters after the first step (from the same
# weights), under AdamWConfig(eps=1e-3), by kind of tower: a tenth of GRAD_TOL, which
# bounds the same towers' card - CPU gradients.  The card's products pick their
# algorithm by shape (B = 2 a shard against B = 4), so the two steps sum in other
# orders; seamless-m4t read 2.0e-5 on its first card call (the CPU: 6e-8), where
# 13(a) read 5.2e-4 of the leaf's scale on its gradients
MESH_PARAM_TOL = {"dense": 1e-5, "moe_or_recurrent": 1e-4}
MESH_PROCS = 2                 # (c), (d): gloo processes sharing the card
EP_ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")      # (b): their MoE layer
EP_SHAPE = (4, 16)             # (b): B x S of the EP layer check
EP_TOL = 1e-4                  # (b): EP against the local path, the reference's test's bar
MESH_FULL = dict(arch="rwkv6-1.6b", mesh=(2, 1), batch=4, seq=512, steps=3)     # (d)
EP_FULL = dict(arch="qwen3-moe-235b-a22b", mesh=(1, 2), B=2, S=256)             # (d)
MESH_CLI = dict(arch="qwen3-moe-235b-a22b", steps=6, ckpt_every=3, batch=4, seq=32,
                mesh="2x2", resume_mesh="1x2")                        # (f)
# (f): |resumed - straight| on every parameter; a CPU run of the same drill read 3.0e-8
# (the resumed run sums each gradient over 1 data shard where the straight run sums 2)
MESH_CLI_TOL = 1e-5
MESH_SPAWN_TIMEOUT = 300       # (c), (d): seconds the spawned ranks may take
MESH_KERNELS = ("expand_score", "beam_merge", "prune_sweep")         # (e)'s path
# phase 15: the dry-run's cells, its tally and the roofline beside measured steps
DRYRUN_CELLS = (("qwen1.5-4b", "train_4k"), ("qwen3-moe-235b-a22b", "decode_32k"),
                (None, "index"))                  # (a): --mesh single; None: --index-cell
DRYRUN_TIMEOUT = 120           # (a): seconds the three dry-run subprocesses may take
DRYRUN_KERNELS = ("expand_score", "beam_merge")   # (d)'s path: the index cell's step
# phase 16: tensor parallelism in the mesh train step, 2 float32 steps, then 1 bf16 step
TP_FULL = dict(arch="qwen3-32b", layers=2, mesh=(1, 2), batch=2, seq=256, seed=0,
               runs=[dict(dtype="float32", steps=2, params=True),
                     dict(dtype="bfloat16", steps=1, params=False)])
# float32: the parameters after step 1 within the CPU tests' bound (under eps = 1e-3 a
# parameter moves by about lr * g / eps, so this is a bound on the update as well);
# bf16 parameters are not compared: one moves by a whole bf16 step, 2^-8 of its size,
# wherever two float32 updates round to either side of one
TP_PARAM_TOL = 1e-6
# step 1's loss and grad norm against the one-device step's, relative: float32 as the CPU
# tests hold the loss; bf16 one rounding of the result (bf16's unit roundoff, 2^-8)
TP_METRIC_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
TP_PEAK_RATIO = 0.6            # float32: a process's peak over the one-device step's, at most
TP_SPAWN_TIMEOUT = 120         # seconds the spawned ranks may take
# the ranks fork from a server started with the script, which has imported these by then
# (a spawned process spends 8-14 s importing torch, and remat's first backward 8-11 s
# more importing torch._dynamo)
TP_PRELOAD = ("repro_torch.launch.sharded", "torch._dynamo")
# phase 17: the MoE archs' experts split along model, one float32 cell held to a one-device
# step run first (its parameters, moments and gradients do not fit beside the processes)
MOE_TP_FULL = dict(arch="qwen3-moe-235b-a22b", layers=1, mesh=(1, 2), batch=2, seq=256,
                   seed=0, runs=[dict(dtype="float32", steps=2, params=True)])
MOE_TP_CUT = (
    "n_layers 94 -> 1 at full width, float32, B = 2, S = 256: 3,732,418,816 parameters, "
    "2,415,919,104 of them the experts; one device holds params 14.9 GB + moments 29.9 GB "
    "+ gradients 14.9 GB = ~60 GB; a process of (1, 2) its blocks (1,866,215,680 "
    "parameters: experts, vocab, heads and router split) at 7.5 + 14.9 + 7.5 GB plus the "
    "reduce's copies of the largest expert leaf (~3.2 GB) = ~33 GB, so the two processes "
    "take ~66 GB and the one-device step runs before them, alone")
# phase 18: rwkv6, zamba2 and encdec split along model, each cell at full width held to
# one-device steps run first (as phase 17's), the three cells in one start of the ranks:
# float32, and zamba2 and seamless-m4t in float64 too (their float32 parameters round too
# far to be held to 1e-6, see FAMILY_TP_TOL); zamba2 takes one step a run (~5 s of gloo a
# step: its w_in's whole float32 gradient summed over model)
F32, F64 = (dict(dtype=d, steps=1, params=True) for d in ("float32", "float64"))
FAMILY_TP_FULL = (
    dict(arch="rwkv6-1.6b", layers=2, mesh=(1, 2), batch=2, seq=256, seed=0,
         runs=[dict(F32, steps=2)]),
    dict(arch="zamba2-2.7b", layers=6, mesh=(1, 2), batch=2, seq=256, seed=0,
         runs=[F32, F64]),
    dict(arch="seamless-m4t-medium", layers=2, enc_layers=2, frames=256, mesh=(1, 2), batch=2,
         seq=256, seed=0, runs=[dict(F32, steps=2), F64]))
FAMILY_TP_CUTS = {
    "rwkv6-1.6b": (
        "n_layers 24 -> 2 at full width (d 2,048, 32 heads of 64, d_ff 7,168, vocab 65,536), "
        "float32, B = 2, S = 256: 378,058,752 parameters, one device ~1.5 GB params + 3.0 GB "
        "moments + 1.5 GB gradients"),
    "zamba2-2.7b": (
        "n_layers 54 -> 6 at full width (d 2,560, d_inner 5,120 in 80 Mamba heads, state "
        "64; the shared block's 32 heads, d_ff 10,240; vocab 32,000): one period, its 6 "
        "Mamba layers and one shared-attention site, float32 and float64, B = 2, S = 256: "
        "508,003,232 parameters"),
    "seamless-m4t-medium": (
        "enc_layers 12 -> 2, n_layers 12 -> 2 at full width (d 1,024, 16 heads, d_ff "
        "4,096, vocab 256,206: 2-way split), float32 and float64, B = 2, S = 256 tokens "
        "and 256 seeded frames: 601,268,224 parameters"),
}
# step 1 against the one-device step, (arch, dtype) -> (parameters under eps = 1e-3, or
# None: held in float64; loss relative; grad norm relative).  Each bound is 1e-6, or 2-3
# times the largest of seeds 0-3 where that is more (zamba2's and seamless-m4t's float32
# grad norms 1.4 and 1.3 times: phase 18's seed 0 reads 1.2e-6 and 7.2e-3), on an H100
# 80GB HBM3 at 700 W
# (``python -m repro_torch.bench.split_rounding --seeds 0 1 2 3``; PERF.md section 6),
# where a one-device step from weights moved by 2^-24 lies as far as the split does: in
# float32 split / unsplit (2, 1) / perturbed, rwkv6 6.0e-7 / 8.7e-7 / 4.8e-7, 8.3e-8 / 8.3e-8
# / 8.3e-8, 1.8e-5 / 2.7e-5 / 1.4e-5; zamba2 1.8e-6 / 1.8e-6 / 1.6e-6, 3.5e-7 / 5.3e-7 /
# 5.3e-7, 7.0e-5 / 1.1e-4 / 2.0e-4; seamless-m4t 3.4e-4 / 4.1e-4 / 3.9e-4 (of a 5e-4 first
# update: no float32 bound can tell a dropped gradient from rounding, so float64 holds its
# parameters), 1.7e-5 / 3.0e-5 / 1.8e-5, 4.0e-2 / 3.5e-2 / 4.1e-2; the split in float64
# (its norms, scans, attention and loss still round in float32) zamba2 2.6e-7, 8.8e-8,
# 7.8e-6 and seamless-m4t 1.2e-7, 0, 1.7e-7
FAMILY_TP_TOL = {("rwkv6-1.6b", "float32"): (TP_PARAM_TOL, 1e-6, 5e-5),
                 ("zamba2-2.7b", "float32"): (5e-6, 1e-6, 1e-4),
                 ("zamba2-2.7b", "float64"): (TP_PARAM_TOL, 1e-6, 2e-5),
                 ("seamless-m4t-medium", "float32"): (None, 5e-5, 5e-2),
                 ("seamless-m4t-medium", "float64"): (TP_PARAM_TOL, 1e-6, 1e-6)}
# phase 19: the decoders' split prefill and decode, each cell held to a one-device run made
# first, then to the same split in one process (bitwise), in two gloo processes
SERVE_TP = dict(batch=2, prompt=240, cache=256, steps=16, lens=[240, 229], seed=0,
                dtype="float32", reduced=False)
SERVE_TP_FULL = (
    dict(SERVE_TP, arch="qwen3-32b", layers=2, mesh=(1, 2)),       # its 8 kv heads split
    dict(SERVE_TP, arch="qwen3-32b", layers=2, mesh=(1, 16)),      # 8 kv heads on 16: positions
    dict(SERVE_TP, arch="minicpm3-4b", layers=2, mesh=(1, 2)),     # MLA: positions
    dict(SERVE_TP, arch="qwen3-moe-235b-a22b", layers=1, mesh=(1, 2)))
SERVE_TP_CUTS = {
    "qwen3-32b": "n_layers 64 -> 2 at full width: 2,531,026,432 parameters, ~10 GB in float32",
    "minicpm3-4b": "n_layers 62 -> 2 at full width: 501,406,208 parameters",
    "qwen3-moe-235b-a22b": ("n_layers 94 -> 1 at full width: 3,732,418,816 parameters, ~15 GB "
                            "in float32, 64 of its 128 experts a process")}
# (arch, mesh) -> the bound on max |split - one device| / max |one device| of (logits,
# caches): 3 times the largest distance of a one-device run from weights each scaled by
# 1 + 2^-24 N(0, 1), over seeds 0-3 on an H100 80GB HBM3 at 700 W (python -m
# repro_torch.bench.split_rounding --serve; PERF.md section 6), where the split read at
# most 1.47e-6 / 1.84e-6 (qwen3-32b), 6.68e-6 / 1.86e-6 (minicpm3-4b) and 2.00e-6 /
# 5.37e-7 (qwen3-moe)
SERVE_TP_TOL = {("qwen3-32b", (1, 2)): (3 * 1.41e-6, 3 * 1.26e-6),
                ("qwen3-32b", (1, 16)): (3 * 1.41e-6, 3 * 1.26e-6),
                ("minicpm3-4b", (1, 2)): (3 * 9.31e-6, 3 * 3.16e-6),
                ("qwen3-moe-235b-a22b", (1, 2)): (3 * 1.46e-6, 3 * 3.28e-7)}
# phases 13(c) and 14(d) leave their measured numbers here for phase 15
MEASURED = {}
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_TF32_PER_S = 495e12       # H100 SXM TF32 on the tensor cores, dense
PEAK_BF16_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
N_L2_INT = (1_000, 8_192)      # queries x corpus rows of the integer-data bitwise check
KERNELS = {
    "expand_score": ("src/repro_torch/kernels/csrc/expand_score.cu",
                     "src/repro/kernels/expand_score.py:63"),
    "expand_score_bf16": ("src/repro_torch/kernels/csrc/expand_score.cu",
                          "src/repro/kernels/expand_score.py:63"),
    "expand_score_q": ("src/repro_torch/kernels/csrc/expand_score_q.cu",
                       "src/repro/kernels/expand_score.py:110"),
    "expand_score_pq": ("src/repro_torch/kernels/csrc/expand_score_pq.cu",
                        "src/repro/kernels/expand_score.py:250"),
    "beam_merge": ("src/repro_torch/kernels/csrc/beam_merge.cu",
                   "src/repro/kernels/beam_merge.py:132"),
    "prune_sweep": ("src/repro_torch/kernels/csrc/prune_sweep.cu",
                    "src/repro/kernels/prune_sweep.py:167"),
    "pairwise_sq_dist": ("src/repro_torch/kernels/csrc/l2dist.cu",
                         "src/repro/kernels/l2dist.py:49"),
    "filtered_topk": ("src/repro_torch/kernels/csrc/fused_scan.cu",
                      "src/repro/kernels/fused_scan.py:87"),
}

# How each kernel is held to its plain version: bitwise, or (the tensor-core
# products of pairwise_sq_dist and filtered_topk, 3xTF32) within a stated
# rule, and bitwise on small-integer data.
CHECKED = {name: dict(bitwise=True) for name in KERNELS}
CHECKED["pairwise_sq_dist"] = dict(
    bitwise=False, bitwise_on_integer_data=True,
    tolerance="|kernel - plain| <= (d + 4) * 2^-23 * (|q|^2 + |x|^2) elementwise")
CHECKED["filtered_topk"] = dict(
    bitwise=False, bitwise_on_integer_data=True,
    tolerance="with tol_i = (d + 4) * 2^-23 * (|q_i|^2 + max_j |x_j|^2): the +inf pattern "
              "equal; sorted values within tol_i; ids distinct, passing the predicate, "
              "their plain distances within tol_i of their values and at most the plain "
              "k-th value + 2 tol_i (fused_scan.rule_violations)")


# further keys a kernel's row carries into the kernels line where it has them
EXTRA_KEYS = ("bound_simt_ms", "bound_simt_by", "bf16_ms", "bf16_bound_ms", "bf16_bound_by")


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def children_left() -> list[str]:
    """This process's child processes that still exist, as ``"pid command"``."""
    me = str(os.getpid())
    left = []
    for proc in pathlib.Path("/proc").glob("[0-9]*"):
        try:
            stat = (proc / "stat").read_text()
            cmd = (proc / "cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")
        except OSError:     # it ended while we looked
            continue
        if stat.rsplit(")", 1)[1].split()[1] == me:     # the field after the state is the parent
            left.append(f"{proc.name} {cmd.strip()}")
    return left


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    import torch

    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, peak: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def product_bounds(cost, bf16_bytes: int) -> dict:
    """The bounds of a product kernel from its float32 cost in
    ``kernels/ops.py``: ``bound_ms`` the tightest the card allows an
    fp32-accurate product (3xTF32 on the tensor cores: three products), the
    fp32 SIMT bound (with the other operations) and the bf16 entry's
    (``bf16_bytes`` moved) beside it."""
    flops, other, nbytes = cost[:3]
    tc = bound(nbytes, 3 * flops, PEAK_TF32_PER_S)
    simt = bound(nbytes, flops + other)
    bf = bound(bf16_bytes, flops, PEAK_BF16_PER_S)
    return dict(bound_ms=tc[0], bound_by=tc[1], bound_simt_ms=simt[0], bound_simt_by=simt[1],
                bf16_bound_ms=bf[0], bf16_bound_by=bf[1])


def kernel_bound(cost) -> tuple[float, str]:
    """:func:`bound` of a kernel without products from its cost in
    ``kernels/ops.py`` (``(product FLOPs, other operations, bytes, ...)``):
    its operations on the fp32 units."""
    check(cost[0] == 0, "kernel_bound: the kernel has products; give their rate")
    return bound(cost[2], cost[1])


def l2dist_within_bound(got, want, q, x, what: str) -> dict:
    """Check ``|kernel − plain| ≤ (d + 4)·2⁻²³·(‖q‖² + ‖x‖²)`` elementwise
    (``l2dist.tolerance``, the stated bound of the tensor-core product), a
    block of query rows at a time with the norms folded once; returns the
    bound's factor, the largest ``|kernel − plain| / (‖q‖² + ‖x‖²)`` and the
    largest ``|kernel − plain|``."""
    from repro_torch.kernels.l2dist import tolerance_terms

    factor, qn, xn = tolerance_terms(q, x)
    qn, xn = qn.double(), xn.double()
    worst, worst_abs = 0.0, 0.0
    for r in range(0, got.shape[0], 1000):
        err = (got[r : r + 1000].double() - want[r : r + 1000].double()).abs()
        norms = qn[r : r + 1000, None] + xn[None, :]
        check(bool((err <= factor * norms).all()),
              f"{what}: kernel outside (d + 4)·2^-23·(|q|² + |x|²) of its plain version")
        worst = max(worst, float((err / norms.clamp_min(1e-30)).max()))
        worst_abs = max(worst_abs, float(err.max()))
    return dict(factor=factor, max_err_over_norms=worst, max_abs_err=worst_abs)


# ----------------------------------------------------------------- phases
def phase0_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from repro_torch.kernels.util import no_tf32

    no_tf32()
    emit(phase=0, card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def phase1_build():
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()
    info = cuda_lib.build_info
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "Compiling entry" in ln or "Used" in ln or "spill" in ln]
    emit(phase=1, build_seconds=info.get("seconds", 0.0), cached=info.get("cached"),
         load_seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase2_kernels(dev) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.beam_merge import PAD_PAYLOAD

    rows = {}
    g = torch.Generator(device=dev).manual_seed(1234)

    # expand_score: n = 1M, d = 128, B = 10,000, C = 256, 20 % masked
    n, d, B, C = 1_000_000, 128, 10_000, 256
    x = torch.randn(n, d, generator=g, device=dev)
    q = torch.randn(B, d, generator=g, device=dev)
    idx = torch.randint(0, n, (B, C), generator=g, device=dev, dtype=torch.int32)
    idx = torch.where(torch.rand(B, C, generator=g, device=dev) < 0.2, -1, idx).contiguous()
    got = ops.expand_score(x, idx, q, backend="cuda")
    want = ops.expand_score(x, idx, q, backend="torch")
    torch.cuda.synchronize()
    check(bits_equal(got, want), "expand_score kernel != plain version")
    n_valid = int((idx >= 0).sum())
    b_ms, b_by = kernel_bound(ops._score_cost(got, x, idx, q))
    shape = dict(n=n, d=d, B=B, C=C, masked=B * C - n_valid)
    rows["expand_score"] = dict(
        ms=cuda_ms(lambda: ops.expand_score(x, idx, q, backend="cuda")),
        plain_ms=cuda_ms(lambda: ops.expand_score(x, idx, q, backend="torch"), reps=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs_err(got, want),
        shape=shape)

    # the same candidates on the bf16, int8 and pq planes of the same rows
    from repro_torch.core.store import VectorPlane
    from repro_torch.kernels.expand_score import pq_lut

    planes = {
        "expand_score_bf16": VectorPlane.encode(x, "bf16"),
        "expand_score_q": VectorPlane.encode(x, "int8"),
        "expand_score_pq": VectorPlane(
            "pq", torch.randint(0, 256, (n, PQ_M), generator=g, device=dev, dtype=torch.uint8),
            codebooks=torch.randn(PQ_M, 256, d // PQ_M, generator=g, device=dev)),
    }
    del x
    lut = pq_lut(planes["expand_score_pq"].codebooks, q)
    lut_ms = cuda_ms(lambda: pq_lut(planes["expand_score_pq"].codebooks, q), reps=5)
    for name, plane in planes.items():
        run = lambda b: ops.expand_score_plane(plane, idx, q, backend=b, lut=lut)
        got, want = run("cuda"), run("torch")
        torch.cuda.synchronize()
        check(bits_equal(got, want), f"{name} kernel != plain version")
        b_ms, b_by = kernel_bound(ops._score_plane_cost(got, plane, idx, q))
        rows[name] = dict(
            ms=cuda_ms(lambda: run("cuda")), plain_ms=cuda_ms(lambda: run("torch"), reps=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by, max_abs_err=max_abs_err(got, want),
            shape=dict(shape, m=PQ_M) if plane.tag == "pq" else shape)
    emit(phase=2, pq_lut_ms=lut_ms, pq_lut_shape=dict(B=B, m=PQ_M, K=256, dsub=d // PQ_M))
    del planes, lut, q, idx, got, want

    # beam_merge: B = 10,000, E = 64, L = 256, with ties, +inf and pads
    B, E, L = 10_000, 64, 256
    pool = torch.tensor([0.25, 0.5, 1.0, 2.0, float("inf")], device=dev)
    bd = pool[torch.randint(0, 5, (B, E), generator=g, device=dev)]
    bp = torch.randint(0, 500_000, (B, E), generator=g, device=dev, dtype=torch.int32) << 1
    bp = torch.where(torch.isfinite(bd), bp, PAD_PAYLOAD)
    bd, o = torch.sort(bd, dim=-1, stable=True)
    bp = torch.gather(bp, -1, o).contiguous()
    bd = bd.contiguous()
    cd = pool[torch.randint(0, 5, (B, L), generator=g, device=dev)].contiguous()
    cp = (torch.randint(0, 500_000, (B, L), generator=g, device=dev, dtype=torch.int32) << 1)
    cp = torch.where(torch.isfinite(cd), cp, PAD_PAYLOAD).contiguous()
    got = ops.beam_merge(bd, bp, cd, cp, backend="cuda")
    want = ops.beam_merge(bd, bp, cd, cp, backend="torch")
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)), "beam_merge kernel != plain version")
    cat_d = torch.cat([bd, cd], dim=1)
    b_ms, b_by = kernel_bound(ops._merge_cost(got, bd, bp, cd, cp))
    rows["beam_merge"] = dict(
        ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="cuda")),
        plain_ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="torch"), reps=5),
        library_ms=cuda_ms(lambda: torch.topk(cat_d, E, dim=1, largest=False, sorted=True)),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        shape=dict(B=B, E=E, L=L))
    # the same beams against L = 2048 candidates (the paper's degree 256 + 256
    # at W = 4: several warps a row), bitwise, timed beside its bound
    L = 2048
    cd = pool[torch.randint(0, 5, (B, L), generator=g, device=dev)].contiguous()
    cp = (torch.randint(0, 500_000, (B, L), generator=g, device=dev, dtype=torch.int32) << 1)
    cp = torch.where(torch.isfinite(cd), cp, PAD_PAYLOAD).contiguous()
    got = ops.beam_merge(bd, bp, cd, cp, backend="cuda")
    want = ops.beam_merge(bd, bp, cd, cp, backend="torch")
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)),
          "beam_merge kernel != plain version at L = 2048")
    b_ms, b_by = kernel_bound(ops._merge_cost(got, bd, bp, cd, cp))
    rows["beam_merge"]["paper_degree"] = dict(
        ms=cuda_ms(lambda: ops.beam_merge(bd, bp, cd, cp, backend="cuda")),
        bound_ms=b_ms, bound_by=b_by, bitwise=True, shape=dict(B=B, E=E, L=L))
    del bd, bp, cd, cp, cat_d, got, want

    # prune_sweep: B = 1024, C = 96, d = 128, point intervals, all-pad rows
    B, C, d = 1024, 96, 128
    xs = torch.randn(B, C, d, generator=g, device=dev)
    i_c = torch.sort(torch.rand(B, C, 2, generator=g, device=dev), dim=-1).values
    i_c[::7, :, 1] = i_c[::7, :, 0]                         # point intervals
    i_u = torch.sort(torch.rand(B, 2, generator=g, device=dev), dim=-1).values
    i_u[::13, 1] = i_u[::13, 0]
    d_uc = torch.sort(torch.rand(B, C, generator=g, device=dev) * 2 * d, dim=-1).values
    valid = torch.rand(B, C, generator=g, device=dev) >= 0.1
    valid[::50] = False                                     # all-pad rows
    d_uc = torch.where(valid, d_uc, torch.inf)
    overlap = (torch.maximum(i_u[:, None, 0], i_c[..., 0])
               <= torch.minimum(i_u[:, None, 1], i_c[..., 1]))
    args = [t.contiguous() for t in (i_u, xs, i_c, d_uc, valid.int(), overlap.int())]
    kw = dict(m_if=32, m_is=32, alpha=1.0, unified=True)
    got = ops.prune_sweep(*args, backend="cuda", **kw)
    want = ops.prune_sweep(*args, backend="torch", **kw)
    torch.cuda.synchronize()
    check(all(bits_equal(a, b) for a, b in zip(got, want)), "prune_sweep kernel != plain version")
    cost = ops._sweep_cost(got, *args, **kw)
    pairs = cost[1] // (3 * d)              # valid t against retained w < t, 3·d operations each
    b_ms, b_by = kernel_bound(cost)
    rows["prune_sweep"] = dict(
        ms=cuda_ms(lambda: ops.prune_sweep(*args, backend="cuda", **kw)),
        plain_ms=cuda_ms(lambda: ops.prune_sweep(*args, backend="torch", **kw), reps=3, warm=1),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=max(max_abs_err(a, b) for a, b in zip(got, want)),
        shape=dict(B=B, C=C, d=d, pairs=pairs))
    for name, r in rows.items():
        emit(kernel=name, **CHECKED[name], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
             library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
             shape=r["shape"], **{k: r[k] for k in ("paper_degree",) if k in r})
    return rows


def mixed_workload(ccfg, nq: int, dev):
    """10,000-style mixed batch: semantics cycling IF/IS/RS/RF; RS rows get
    point windows at the centre of their uniform window."""
    import torch

    from repro_torch.core import Semantics
    from repro_torch.data import make_queries

    cycle = [Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF]
    qv, wide = make_queries(ccfg, nq, workload="uniform", device=dev)
    _, point = make_queries(ccfg, nq, workload="point", device=dev)
    sems = [cycle[i % 4] for i in range(nq)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qi = torch.where(is_rs[:, None], point, wide)
    return qv, qi, sems


def scored_queries(idx, qv, qi, sems) -> dict:
    """The first ``PER_SEM`` queries of each semantics and their exact top 10."""
    import torch

    out = {}
    for s in sorted(set(sems), key=lambda s: s.value):
        sel = torch.tensor([i for i, ss in enumerate(sems) if ss is s][:PER_SEM], device=qv.device)
        out[s] = (sel, idx.ground_truth(qv[sel], qi[sel], sem=s, k=10))
    return out


def recall_per_semantics(res, scored) -> dict:
    """recall@10 per semantics of ``res`` over the queries of ``scored``."""
    from repro_torch.core import recall

    return {s.value: recall(subset(res, sel), truth) for s, (sel, truth) in scored.items()}


def mean(values) -> float:
    values = list(values)
    return sum(values) / len(values)


def subset(res, sel):
    from repro_torch.core import SearchResult

    return SearchResult(res.ids[sel], res.dist[sel], res.steps[sel])


def same_result(a, b) -> bool:
    return (bits_equal(a.ids, b.ids) and bits_equal(a.dist, b.dist)
            and bits_equal(a.steps, b.steps))


def phase3_main_path(dev):
    import statistics

    import torch

    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_corpus
    from repro_torch.kernels import ops

    n, nq = N_MAIN, N_QUERIES
    ccfg = CorpusConfig(n=n, dim=128, seed=0)
    cfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                   iterations=3, exact_spatial=n <= 8192)
    torch.cuda.reset_peak_memory_stats()
    x, ints = make_corpus(ccfg, device=dev)
    qv, qi, sems = mixed_workload(ccfg, nq, dev)
    torch.cuda.synchronize()

    marks = {}

    def progress(msg):
        if msg.startswith("candidates"):
            torch.cuda.synchronize()
            marks["candidates"] = time.perf_counter()

    ops.reset_launches()                                   # the main path's run
    t_build = time.perf_counter()
    idx = UGIndex.build(x, ints, cfg, seed=0, device=dev, progress=progress)
    idx.search_mixed(qv, qi, sems, **SEARCH)                # warm-up
    seconds = []
    for _ in range(TIMED_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.search_mixed(qv, qi, sems, **SEARCH)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = dict(ops.launches)

    scored = scored_queries(idx, qv, qi, sems)
    recalls = recall_per_semantics(res, scored)
    # the same scored queries through wider beams: recall that climbs with
    # ef says the graph leads to the true neighbours, only slowly
    sel = torch.cat([s for s, _ in scored.values()])
    pos = torch.empty(nq, dtype=torch.long, device=dev)
    pos[sel] = torch.arange(len(sel), device=dev)
    narrowed = {s: (pos[s_sel], truth) for s, (s_sel, truth) in scored.items()}
    sems_sel = [sems[i] for i in sel.tolist()]
    by_ef = {}
    for ef in WIDE_EFS:
        r = idx.search_mixed(qv[sel], qi[sel], sems_sel, ef=ef, k=10, width=4)
        by_ef[ef] = dict(recall_at_10=recall_per_semantics(r, narrowed), iters=r.iters,
                         mean_steps=float(r.steps.float().mean()))
    # queries drawn around corpus rows, with the corpus's own cluster spread
    g = torch.Generator(device=dev).manual_seed(7)
    rows = torch.randint(0, n, (nq,), generator=g, device=dev)
    qv_in = x[rows] + ccfg.cluster_std * torch.randn(nq, 128, generator=g, device=dev)
    res_in = idx.search_mixed(qv_in, qi, sems, **SEARCH)
    scored_in = scored_queries(idx, qv_in, qi, sems)
    recalls_in = recall_per_semantics(res_in, scored_in)
    mem = idx.vector_memory_bytes()
    med = statistics.median(seconds)
    emit(phase=3, n=n, d=128, queries=nq, build_seconds=idx.build_seconds,
         candidates_seconds=marks["candidates"] - t_build,
         degree_stats=idx.degree_stats(), graph_width=idx.graph.max_degree,
         graph_bytes=idx.memory_bytes(), plane_bytes=mem["plane"],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         search_seconds=seconds, qps=nq / med, qps_min=nq / max(seconds),
         qps_max=nq / min(seconds), iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         recall_at_10_wider_beams=by_ef,
         recall_at_10_corpus_queries=recalls_in, iters_corpus_queries=res_in.iters,
         launches=launches)
    return dict(idx=idx, queries=(qv, qi, sems), scored=scored, recalls=recalls, qps=nq / med,
                launches=launches, qv_in=qv_in, scored_in=scored_in, res=res)


def search_checks(idx, queries, dev, what: str) -> None:
    """On the first 1,000 queries: the kernel path equals the plain path
    bitwise, and the mixed batch equals four per-semantics batches."""
    import torch

    qv, qi, sems = queries
    sub = slice(0, 1000)
    r_cuda = idx.search_mixed(qv[sub], qi[sub], sems[sub], backend="cuda", **SEARCH)
    r_torch = idx.search_mixed(qv[sub], qi[sub], sems[sub], backend="torch", **SEARCH)
    check(same_result(r_cuda, r_torch) and r_cuda.iters == r_torch.iters,
          f"{what} search: backend='cuda' != backend='torch'")
    for s in set(sems[sub]):
        sel = [i for i, ss in enumerate(sems[sub]) if ss is s]
        one = idx.search(qv[sel], qi[sel], sem=s, **SEARCH)
        check(same_result(subset(r_cuda, torch.tensor(sel, device=dev)), one),
              f"{what}: mixed batch != per-semantics batch for {s.value}")


def phase4_checks(dev, main):
    import torch

    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_corpus

    launches = main["launches"]
    out = {}
    # (a) every kernel of the f32 path ran on it
    for name in PATH_KERNELS["f32"]:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the main path")
    out["a_launches"] = launches

    # (b) kernel path == plain path and (c) the mixed batch equals four
    # per-semantics batches, on 1,000 queries
    search_checks(main["idx"], main["queries"], dev, "f32")
    out["b_search_bitwise"] = True
    out["c_mixed_equals_per_semantics"] = True

    # (d) a 50,000-row build: prune_backend cuda == torch
    ccfg = CorpusConfig(n=N_CHECK, dim=128, seed=1)
    x, ints = make_corpus(ccfg, device=dev)
    base = dict(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32, iterations=3)
    idx50 = UGIndex.build(x, ints, UGConfig(**base, prune_backend="cuda"), device=dev)
    g_torch = UGIndex.build(x, ints, UGConfig(**base, prune_backend="torch"), device=dev).graph
    check(bits_equal(idx50.graph.nbrs, g_torch.nbrs)
          and bits_equal(idx50.graph.status, g_torch.status),
          "build: prune_backend='cuda' != 'torch'")
    out["d_build_bitwise"] = True

    # (e) tripwires: a broken graph or kernel gives recall near 0.  The
    # workload's query centres lie apart from the corpus's, and recall at
    # ef = 64 falls with n, so the 0.2 bar is held at 50,000 rows.  Beside
    # it, an exact-KNN build of the same corpus: NN-descent's share of the
    # recall lost.
    qv50, qi50, sems50 = mixed_workload(ccfg, 4 * PER_SEM, dev)
    scored50 = scored_queries(idx50, qv50, qi50, sems50)
    recalls50 = recall_per_semantics(idx50.search_mixed(qv50, qi50, sems50, **SEARCH), scored50)
    exact50 = UGIndex.build(x, ints, UGConfig(**base, exact_spatial=True), device=dev)
    recalls_exact = recall_per_semantics(
        exact50.search_mixed(qv50, qi50, sems50, **SEARCH), scored50)
    out["e_recall_at_10_50k"] = recalls50
    out["e_recall_at_10_50k_exact_spatial"] = recalls_exact
    out["e_degree_stats_50k"] = idx50.degree_stats()
    out["e_degree_stats_50k_exact_spatial"] = exact50.degree_stats()
    out["e_mean_recall_50k"] = mean50 = mean(recalls50.values())
    out["e_mean_recall_50k_exact_spatial"] = mean(recalls_exact.values())
    out["e_mean_recall_main"] = mean_main = mean(main["recalls"].values())
    check(mean50 >= 0.2, f"mean recall@10 {mean50} < 0.2 at n = {N_CHECK}")
    check(mean_main >= 0.02, f"mean recall@10 {mean_main} < 0.02 on the main path")
    emit(phase=4, **out)
    return dict(idx=idx50, queries=(qv50, qi50, sems50), scored=scored50, mean=mean50)


def phase5_planes(dev, main, check50) -> dict:
    """The quantized path on phase 3's graph; returns each plane's launches."""
    import statistics

    import torch

    from repro_torch.core.store import train_pq_codebooks
    from repro_torch.kernels import ops

    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]
    path_launches = {}
    for tag, rerank in PLANES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_t = idx.with_dtype(tag, rerank=rerank)
        torch.cuda.synchronize()
        encode_seconds = time.perf_counter() - t0
        extra = {}
        if tag == "pq":                                   # training alone, once more
            t0 = time.perf_counter()
            train_pq_codebooks(idx.x)
            torch.cuda.synchronize()
            extra["pq_train_seconds"] = time.perf_counter() - t0

        ops.reset_launches()                              # this plane's path
        idx_t.search_mixed(qv, qi, sems, **SEARCH)          # warm-up
        seconds = []
        for _ in range(TIMED_BATCHES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = idx_t.search_mixed(qv, qi, sems, **SEARCH)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        launches = dict(ops.launches)
        for name in PATH_KERNELS[tag]:
            check(launches[name] > 0, f"{name} was not launched on the {tag} path")
        path_launches[tag] = launches

        recalls = recall_per_semantics(res, main["scored"])
        res_in = idx_t.search_mixed(main["qv_in"], qi, sems, **SEARCH)
        recalls_in = recall_per_semantics(res_in, main["scored_in"])
        search_checks(idx_t, main["queries"], dev, tag)

        idx50 = check50["idx"].with_dtype(tag, rerank=rerank)
        qv50, qi50, sems50 = check50["queries"]
        recalls50 = recall_per_semantics(
            idx50.search_mixed(qv50, qi50, sems50, **SEARCH), check50["scored"])
        mean50 = mean(recalls50.values())
        check(mean50 >= 0.5 * check50["mean"],
              f"{tag}: mean recall@10 {mean50} < half of f32's {check50['mean']} at n = {N_CHECK}")

        mem = idx_t.vector_memory_bytes()
        med = statistics.median(seconds)
        emit(phase=5, plane=tag, rerank=rerank, n=idx_t.n, d=idx_t.store.dim,
             plane_bytes=mem["plane"], rerank_bytes=mem["rerank"],
             plane_bytes_per_vector=mem["plane_bytes_per_vector"],
             encode_seconds=encode_seconds, **extra, queries=nq,
             search_seconds=seconds, qps=nq / med, qps_min=nq / max(seconds),
             qps_max=nq / min(seconds), iters=res.iters,
             mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
             mean_recall_at_10=mean(recalls.values()),
             recall_at_10_corpus_queries=recalls_in,
             recall_at_10_50k=recalls50, mean_recall_at_10_50k=mean50,
             mean_recall_at_10_50k_f32=check50["mean"], launches=launches,
             checks=dict(search_bitwise=True, mixed_equals_per_semantics=True))
        del idx_t, idx50
    return path_launches


def same_topk(a, b) -> bool:
    return all(bits_equal(x, y) for x, y in zip(a, b))


def phase6_bench(dev, main) -> tuple[dict, dict]:
    """The bench path; returns the two scan kernels' rows and the path's
    launches."""
    import torch

    from repro_torch.bench import common, tables
    from repro_torch.core import Semantics
    from repro_torch.core import intervals as iv
    from repro_torch.core.baselines import prefilter_search
    from repro_torch.core.exact import build_exact
    from repro_torch.core.search import brute_force
    from repro_torch.data import CorpusConfig, make_queries
    from repro_torch.kernels import ops

    idx = main["idx"]
    x, ints = idx.x, idx.intervals
    n, d = x.shape
    ccfg = CorpusConfig(n=n, dim=d, seed=0)
    qv, qi = make_queries(ccfg, N_QUERIES, workload="uniform", device=dev)
    nq = qv.shape[0]
    rows = {}

    # (a) pairwise_sq_dist, f32 and bf16, within the stated bound; bitwise
    # on integer-valued data
    xl = x[:N_L2]
    nx = xl.shape[0]
    ratio = {}
    for tag, (qa, xa) in (("f32", (qv, xl)), ("bf16", (qv.to(torch.bfloat16), xl.to(torch.bfloat16)))):
        got = ops.pairwise_sq_dist(qa, xa, backend="cuda")
        want = ops.pairwise_sq_dist(qa, xa, backend="torch")
        torch.cuda.synchronize()
        ratio[tag] = l2dist_within_bound(got, want, qa, xa, f"pairwise_sq_dist ({tag})")
        del got, want
    gi = torch.Generator(device=dev).manual_seed(77)
    qi8, xi8 = (torch.randint(-8, 9, (m, d), generator=gi, device=dev).float() for m in N_L2_INT)
    for dt in (torch.float32, torch.bfloat16):
        got = ops.pairwise_sq_dist(qi8.to(dt), xi8.to(dt), backend="cuda")
        want = ops.pairwise_sq_dist(qi8.to(dt), xi8.to(dt), backend="torch")
        torch.cuda.synchronize()
        check(bits_equal(got, want), f"pairwise_sq_dist kernel != plain version on integer data ({dt})")
    del got, want, qi8, xi8
    emit(phase=6, pairwise_sq_dist_max_err_over_norms={
             t: r["max_err_over_norms"] for t, r in ratio.items()},
         bound_over_norms=ratio["f32"]["factor"], integer_bitwise=dict(shape=N_L2_INT + (d,)))
    qb, xb = qv.to(torch.bfloat16), xl.to(torch.bfloat16)
    rows["pairwise_sq_dist"] = dict(
        bf16_ms=cuda_ms(lambda: ops.pairwise_sq_dist(qb, xb, backend="cuda"), reps=10),
        library_ms=cuda_ms(lambda: torch.cdist(qv, xl), reps=10),
        library="torch.cdist (adds a square root)",
        **product_bounds(ops._l2_cost(None, qv, xl), ops._l2_cost(None, qb, xb)[2]),
        max_abs_err=max(r["max_abs_err"] for r in ratio.values()),
        max_err_over_norms={t: r["max_err_over_norms"] for t, r in ratio.items()},
        shape=dict(nq=nq, nx=nx, d=d))
    del qb, xb

    # (b) filtered_topk: within its rule on 1,000 queries against the whole
    # corpus and at a ragged small shape; bitwise on integer-valued data
    from repro_torch.kernels.fused_scan import rule_violations

    qs, qis = qv[:N_PLAIN], qi[:N_PLAIN]
    scan, err = {}, 0.0
    for is_filter in (True, False):
        kw = dict(is_filter=is_filter, k=K_SCAN)
        got = ops.filtered_topk(qs, x, ints, qis, backend="cuda", **kw)
        want = ops.filtered_topk(qs, x, ints, qis, backend="torch", **kw)
        torch.cuda.synchronize()
        broken = rule_violations(qs, x, ints, qis, got=got, want=want, is_filter=is_filter)
        check(not broken, f"filtered_topk outside its rule (is_filter={is_filter}): {broken}")
        err = max(err, max_abs_err(got[0], want[0]))
        small = (qv[:77], x[:3001], ints[:3001], qi[:77])
        for k in (1, 64):
            got_s = ops.filtered_topk(*small, is_filter=is_filter, k=k, backend="cuda")
            want_s = ops.filtered_topk(*small, is_filter=is_filter, k=k, backend="torch")
            broken = rule_violations(*small, got=got_s, want=want_s, is_filter=is_filter)
            check(not broken, f"filtered_topk outside its rule at 77 x 3001, k = {k}: {broken}")
        scan[is_filter] = got
    qi8, xi8 = (torch.randint(-8, 9, (m, d), generator=gi, device=dev).float()
                for m in (N_PLAIN, N_L2))
    for dt in (torch.float32, torch.bfloat16):
        for is_filter in (True, False):
            case = (qi8.to(dt), xi8.to(dt), ints[:N_L2], qis)
            kw = dict(is_filter=is_filter, k=K_SCAN)
            check(same_topk(ops.filtered_topk(*case, backend="cuda", **kw),
                            ops.filtered_topk(*case, backend="torch", **kw)),
                  f"filtered_topk kernel != plain version on integer data ({dt}, {is_filter})")
    del qi8, xi8
    emit(phase=6, filtered_topk_within_rule=dict(queries=N_PLAIN, nx=n, small=[77, 3001, [1, 64]]),
         filtered_topk_max_abs_err=err, integer_bitwise=dict(shape=[N_PLAIN, N_L2, d]))
    qb, xb = qv.to(torch.bfloat16), x.to(torch.bfloat16)
    bounds = product_bounds(ops._scan_cost(None, qv, x, ints, qi, k=K_SCAN),
                            ops._scan_cost(None, qb, xb, ints, qi, k=K_SCAN)[2])
    rows["filtered_topk"] = dict(
        plain_queries=N_PLAIN, library_ms=None,
        brute_force_ms=cuda_ms(lambda: brute_force(x, ints, qv, qi, sem=Semantics.IF, k=K_SCAN),
                               reps=1, warm=1),
        bf16_ms=cuda_ms(lambda: ops.filtered_topk(qb, xb, ints, qi, is_filter=True, k=K_SCAN,
                                                  backend="cuda"), reps=3, warm=1),
        **bounds, max_abs_err=err, shape=dict(nq=nq, nx=n, d=d, k=K_SCAN))
    del qb, xb

    # (c) the scan is the exact pre-filter
    prefilter = {}
    for is_filter, sem in ((True, Semantics.IF), (False, Semantics.IS)):
        vals, ids = scan[is_filter]
        truth = prefilter_search(x, ints, qs, qis, sem=sem, k=K_SCAN)
        finite = torch.isfinite(truth.dist)
        check(bool(torch.equal(finite, torch.isfinite(vals))), f"{sem.value}: +inf pattern differs")
        hits = sum(len(set(a[a >= 0].tolist()) & set(b[b >= 0].tolist()))
                   for a, b in zip(ids.cpu().numpy(), truth.ids.cpu().numpy()))
        overlap = hits / max(int(finite.sum()), 1)
        close = bool(torch.allclose(vals[finite], truth.dist[finite], rtol=1e-5, atol=0.0))
        differ = int((ids != truth.ids).any(dim=1).sum())
        prefilter[sem.value] = dict(id_overlap=overlap, values_allclose=close, rows_differ=differ)
        check(overlap >= 0.999 and close, f"filtered_topk vs prefilter_search ({sem.value}): "
              f"overlap {overlap}, allclose {close}")
    del scan
    emit(phase=6, prefilter_cross_check=prefilter)

    # (d) Exp-1, Exp-4 and the kernel table through the bench entry point, on
    # phase 3's index; the kernel table's rows are the two kernels' times
    b = common.Bench(n=n, dim=d, nq=nq, device=dev, cfg=idx.config, corpus=(x, ints), ug=idx)
    ops.reset_launches()                                   # the bench path's run
    bench_rows = tables.bench_ifann(b) + tables.bench_indexing(b) + tables.bench_kernels(
        data=(qv, x, ints, qi), l2_nx=N_L2, plain_nq=N_PLAIN, device=dev)
    launches = dict(ops.launches)
    for r in bench_rows:
        emit(phase=6, row=r["name"], us_per_call=r["us_per_call"], derived=r["derived"],
             **r["metrics"])
    for name in PATH_KERNELS["bench"]:
        check(launches[name] > 0, f"{name} was not launched on the bench path")
    by_name = {r["name"]: r["metrics"] for r in bench_rows}
    for name, row in (("pairwise_sq_dist", "kernel_l2dist"), ("filtered_topk", "kernel_fusedscan")):
        rows[name].update(ms=1e3 * by_name[f"{row}_cuda"]["seconds"],
                          plain_ms=1e3 * by_name[f"{row}_torch_plain"]["seconds"])
        emit(phase=6, kernel=name, **CHECKED[name], **{k: v for k, v in rows[name].items()
                                                       if k != "max_abs_err"})
    check(by_name["ifann_prefilter_exact"]["recall"] == 1.0, "pre-filter recall != 1")
    pf, hp = b.postfilter_index(), b.hipng_index()
    for what, res in (("post-filter", pf.search(qv, qi, sem=Semantics.IF, ef=128, k=10,
                                                oversample=8)),
                      ("Hi-PNG", hp.search(qv, qi, ef=64, k=10))):
        ok = iv.predicate(Semantics.IF, ints[res.ids.clamp(min=0).long()], qi[:, None, :])
        check(bool((ok | (res.ids < 0)).all()), f"{what} returned an id outside its window")
    sub = slice(0, 1000)
    r_cuda = pf.search(qv[sub], qi[sub], sem=Semantics.IF, ef=128, k=10, oversample=8,
                       backend="cuda")
    r_torch = pf.search(qv[sub], qi[sub], sem=Semantics.IF, ef=128, k=10, oversample=8,
                        backend="torch")
    check(same_result(r_cuda, r_torch), "post-filter search: backend='cuda' != 'torch'")

    # (e) build_exact at n = 1,000: prune backends agree; heredity (Thm 3.5)
    xe, ie = x[:N_EXACT], ints[:N_EXACT]
    t0 = time.perf_counter()
    g = build_exact(xe, ie, backend="cuda", device=dev)
    torch.cuda.synchronize()
    exact_cuda_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_torch = build_exact(xe, ie, backend="torch", device=dev)
    torch.cuda.synchronize()
    exact_torch_s = time.perf_counter() - t0
    check(bits_equal(g.nbrs, g_torch.nbrs) and bits_equal(g.status, g_torch.status),
          "build_exact: prune backend cuda != torch")
    mask = iv.query_valid_mask(Semantics.IF, ie, torch.tensor([0.25, 0.75], device=dev))
    rebuilt = build_exact(xe, ie, node_mask=mask, backend="cuda", device=dev)

    def if_edges(graph):
        nb, st = graph.nbrs.cpu().numpy(), graph.status.cpu().numpy()
        return {(u, int(v)) for u in range(nb.shape[0]) for v, f in zip(nb[u], st[u])
                if v >= 0 and f & Semantics.IF.flag}
    check(if_edges(g.induced(mask)) == if_edges(rebuilt), "build_exact: heredity (Thm 3.5) fails")
    emit(phase=6, launches=launches, tripwires=dict(
             filtered_answers_pass_predicate=True, prefilter_recall=1.0,
             postfilter_search_bitwise=True),
         build_exact=dict(n=N_EXACT, d=d, seconds_cuda=exact_cuda_s, seconds_torch=exact_torch_s,
                          max_degree=g.max_degree, edges=int((g.nbrs >= 0).sum()),
                          valid_nodes_of_heredity_window=int(mask.sum()), bitwise=True,
                          heredity=True))
    return rows, launches


def same_store(a, b) -> bool:
    """Every array of two indexes' stores equal bit for bit."""
    sa, sb = a.store, b.store
    if (sa.rerank is None) != (sb.rerank is None):
        return False
    pairs = [(sa.nbrs, sb.nbrs), (sa.status, sb.status), (sa.intervals, sb.intervals),
             (sa.alive, sb.alive), (sa.free, sb.free), (sa.plane.data, sb.plane.data)]
    if sa.rerank is not None:
        pairs.append((sa.rerank.data, sb.rerank.data))
    return all(bits_equal(x, y) for x, y in pairs)


def surfaced(res, ids) -> bool:
    """Whether any of ``ids`` is among the answers of ``res``."""
    import torch

    return bool(torch.isin(res.ids[res.ids >= 0], ids).any())


def timed(fn):
    """``(result, seconds)`` of ``fn()`` with the card synchronised around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def more_rows(n: int, seed: int, extra: int, dev):
    """``extra`` new rows from the mixture of ``make_corpus(n, seed)``: a
    longer draw with the same seed (the cluster centres come first in its
    stream), its rows past ``n``."""
    from repro_torch.data import CorpusConfig, make_corpus

    x, ints = make_corpus(CorpusConfig(n=n + extra, dim=128, seed=seed), device=dev)
    return x[n:].contiguous(), ints[n:].contiguous()


def churn_recalls(m, queries, dev) -> tuple[dict, dict, float]:
    """recall@10 per semantics of a churned index and of a fresh build of
    its live set (same config), and the fresh build's seconds."""
    import torch

    from repro_torch.core import UGIndex

    qv, qi, sems = queries
    recalls = recall_per_semantics(m.search_mixed(qv, qi, sems, **SEARCH),
                                   scored_queries(m, qv, qi, sems))
    live = torch.nonzero(m.alive).flatten()
    fresh, seconds = timed(lambda: UGIndex.build(m.x[live], m.intervals[live], m.config,
                                                 device=dev))
    fresh_recalls = recall_per_semantics(fresh.search_mixed(qv, qi, sems, **SEARCH),
                                         scored_queries(fresh, qv, qi, sems))
    return recalls, fresh_recalls, seconds


def phase7_updates(dev, main, check50, smi) -> dict:
    """Streaming updates on the kernels; returns the update path's launches."""
    import statistics

    import torch

    from repro_torch.core import updates
    from repro_torch.data import CorpusConfig, make_corpus
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(70)

    # (a) 10 % churn of the 50,000-row index, kernels against plain versions
    idx50 = check50["idx"]
    qv50, qi50, sems50 = check50["queries"]
    dels = torch.randperm(idx50.n, generator=g, device=dev)[:N_CHURN_50K].to(torch.int32)
    new_x, new_iv = more_rows(N_CHECK, 1, N_CHURN_50K, dev)
    out, secs = {}, {}
    for backend in ("cuda", "torch"):
        stats = {}
        d, secs[f"delete_{backend}"] = timed(
            lambda: idx50.delete(dels, backend=backend, stats=stats))
        m, secs[f"insert_{backend}"] = timed(lambda: d.insert(
            new_x, new_iv, backend=backend, search_backend=backend, stats=stats))
        out[backend] = (d, m)
    bitwise = [same_store(a, b) for a, b in zip(out["cuda"], out["torch"])]
    d, m = out["cuda"]
    del out
    slots_reused = m.capacity == idx50.capacity and m.n == idx50.n
    hidden = not surfaced(d.search_mixed(qv50, qi50, sems50, **SEARCH), dels)
    res = m.search_mixed(qv50, qi50, sems50, **SEARCH)
    live_only = bool(m.alive[res.ids[res.ids >= 0].long()].all())
    recalls, fresh_recalls, fresh_s = churn_recalls(m, check50["queries"], dev)
    comp = m.compact()
    live = torch.nonzero(m.alive).flatten()
    remap = torch.full((m.capacity,), -1, dtype=torch.long, device=dev)
    remap[live] = torch.arange(live.numel(), device=dev)
    res_c = comp.search_mixed(qv50, qi50, sems50, **SEARCH)
    mapped = torch.where(res.ids >= 0, remap[res.ids.clamp(min=0).long()], -1)
    same_sets = all(set(a[a >= 0].tolist()) == set(b[b >= 0].tolist())
                    for a, b in zip(mapped.cpu(), res_c.ids.cpu()))
    # the same churn with rows from new cluster centres: measured only
    shifted_x, shifted_iv = make_corpus(CorpusConfig(n=N_CHURN_50K, dim=128, seed=71),
                                        device=dev)
    shifted = churn_recalls(d.insert(shifted_x, shifted_iv), check50["queries"], dev)
    emit(phase=7, part="a", card=smi, n=idx50.n, deleted=N_CHURN_50K, inserted=N_CHURN_50K,
         seconds=secs, touched_rows=stats["touched_rows"], repair_blocks=stats["repair_blocks"],
         offer_rounds=stats["offer_rounds"], capacity=m.capacity,
         recall_at_10=recalls, recall_at_10_fresh_build=fresh_recalls,
         fresh_build_seconds=fresh_s,
         other_seed_rows=dict(recall_at_10=shifted[0], recall_at_10_fresh_build=shifted[1]),
         checks=dict(cuda_equals_torch_after_delete=bitwise[0],
                     cuda_equals_torch_after_insert=bitwise[1], deleted_never_surface=hidden,
                     dead_slots_never_surface=live_only, slots_reused=slots_reused,
                     compact_same_answer_sets=same_sets))
    for step, ok in zip(("delete", "insert"), bitwise):
        check(ok, f"7a: {step}: backend='cuda' != 'torch'")
    check(slots_reused, "7a: capacity or live count moved")
    check(hidden and live_only, "7a: a deleted id or a dead slot surfaced")
    for s, r in recalls.items():
        check(r >= fresh_recalls[s] - 0.02,
              f"7a: {s} recall@10 {r} below the fresh build's {fresh_recalls[s]} - 0.02")
    check(same_sets, "7a: compact() changed an answer set")
    del d, m, comp, res, res_c

    # (b) 1 % churn of the 1M index on the kernels, timed
    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]
    dels = torch.randperm(idx.n, generator=g, device=dev)[:N_CHURN_1M].to(torch.int32)
    new_x, new_iv = more_rows(N_MAIN, 0, N_CHURN_1M, dev)
    ops.reset_launches()                                   # the update path's run
    stats = {}
    d, delete_s = timed(lambda: idx.delete(dels, stats=stats))
    # the insert's reverse-offer rounds timed inside it, the card synchronised
    # around them
    rounds, offer_rounds = {}, updates._offer_rounds

    def timed_rounds(*args, **kw):
        n, rounds["seconds"] = timed(lambda: offer_rounds(*args, **kw))
        return n

    updates._offer_rounds = timed_rounds
    try:
        m, insert_s = timed(lambda: d.insert(new_x, new_iv, stats=stats))
    finally:
        updates._offer_rounds = offer_rounds
    launches = dict(ops.launches)
    for name in UPDATE_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the update path")
    check(m.capacity == idx.capacity and m.n == idx.n, "7b: capacity or live count moved")
    check(not surfaced(d.search_mixed(qv, qi, sems, **SEARCH), dels),
          "7b: a deleted id surfaced")
    m.search_mixed(qv, qi, sems, **SEARCH)                   # warm-up
    seconds = []
    for _ in range(TIMED_BATCHES):
        res, t = timed(lambda: m.search_mixed(qv, qi, sems, **SEARCH))
        seconds.append(t)
    check(bool(m.alive[res.ids[res.ids >= 0].long()].all()), "7b: a dead slot surfaced")
    recalls = recall_per_semantics(res, scored_queries(m, qv, qi, sems))
    mean_recall = mean(recalls.values())
    check(mean_recall >= 0.02, f"7b: mean recall@10 {mean_recall} < 0.02 after churn")
    _, compact_s = timed(lambda: m.compact())
    med = statistics.median(seconds)
    emit(phase=7, part="b", card=smi, n=idx.n, d=128, deleted=N_CHURN_1M, inserted=N_CHURN_1M,
         delete_repair_seconds=delete_s, insert_seconds=insert_s, compact_seconds=compact_s,
         touched_rows=stats["touched_rows"], repair_blocks=stats["repair_blocks"],
         offer_rounds=stats["offer_rounds"], offer_rounds_seconds=rounds["seconds"],
         launches=launches, queries=nq, search_seconds=seconds, qps=nq / med, iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         mean_recall_at_10=mean_recall, mean_recall_at_10_before=mean(main["recalls"].values()),
         capacity=m.capacity, checks=dict(deleted_never_surface=True, slots_reused=True))
    del d, m, res

    # (c) inserts into the int8 + rerank and pq + rerank indexes
    new_x, new_iv = make_corpus(CorpusConfig(n=N_QUANT_INSERT, dim=128, seed=73), device=dev)
    quant = {}
    for tag in ("int8", "pq"):
        idx_t = idx.with_dtype(tag, rerank=True)
        got, cuda_s = timed(lambda: idx_t.insert(new_x, new_iv, backend="cuda",
                                                 search_backend="cuda"))
        want, torch_s = timed(lambda: idx_t.insert(new_x, new_iv, backend="torch",
                                                   search_backend="torch"))
        check(same_store(got, want), f"7c: {tag} insert: backend='cuda' != 'torch'")
        quant[tag] = dict(seconds_cuda=cuda_s, seconds_torch=torch_s, capacity=got.capacity,
                          n=got.n, bitwise=True)
        del idx_t, got, want
    emit(phase=7, part="c", card=smi, inserted=N_QUANT_INSERT, planes=quant)
    return launches


def store_tensors(store) -> dict:
    """Every tensor of a store by name, the entry structure's included."""
    named = dict(plane=store.plane.data, intervals=store.intervals, nbrs=store.nbrs,
                 status=store.status, alive=store.alive, free=store.free,
                 scale=store.plane.scale, zero=store.plane.zero,
                 codebooks=store.plane.codebooks,
                 rerank=None if store.rerank is None else store.rerank.data)
    named.update({f"entry_{i}": a for i, a in enumerate(store.entry.arrays())})
    return {k: v for k, v in named.items() if v is not None}


def phase8_serve(dev, main, smi) -> dict:
    """Serving on phase 3's index; returns the serve path's launches (the
    runtime's run, (b))."""
    import collections
    import filecmp
    import shutil

    import numpy as np
    import torch

    from repro_torch import ckpt
    from repro_torch.bench import common, tables
    from repro_torch.ckpt.store import index_tree
    from repro_torch.core import intervals as iv
    from repro_torch.kernels import ops
    from repro_torch.serve import RuntimeConfig, ServeEngine, ServeRuntime
    from repro_torch.serve.engine import bucket_batch_size
    from repro_torch.serve.runtime import count_pinned_matches

    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]
    flags = iv.as_sem_flags(sems, nq, device=dev)
    ef_k = dict(ef=SEARCH["ef"], k=SEARCH["k"])
    ops.reset_launches()                                   # (a)'s run

    # (a) the engine: phase 3's batch through retrieve_mixed, padded
    eng = ServeEngine()
    eng.attach_index(idx, width=SEARCH["width"])
    ptrs = [t.data_ptr() for t in (idx.store.plane.data, idx.store.nbrs)]
    res, retrieve_s = timed(lambda: eng.retrieve_mixed(None, qi, sems, q_v=qv, **ef_k))
    launches_a = dict(ops.launches)
    ref = main["res"]
    check(same_result(res, ref) and res.iters == ref.iters,
          "8a: retrieve_mixed != phase 3's search_mixed")
    check(eng.index is idx and [t.data_ptr() for t in (eng.index.store.plane.data,
                                                       eng.index.store.nbrs)] == ptrs,
          "8a: attach_index copied the store")
    # outside every count: what the bucket padding costs (the padded and the
    # unpadded batch in turns), and where the runtime's time goes: the same requests
    # as sync batches of the micro-batch size through the engine (the search
    # alone), and through a runtime whose queue holds them all before its
    # threads start (no submitter beside the dispatcher)
    turns = dict(padded=lambda: eng.retrieve_mixed(None, qi, sems, q_v=qv, **ef_k),
                 unpadded=lambda: idx.search_mixed(qv, qi, sems, **SEARCH))
    pad_s = {name: [] for name in turns}
    for name in ("padded", "unpadded", "unpadded", "padded"):
        pad_s[name].append(timed(turns[name])[1])
    q_rows, w_rows = qv.cpu().numpy(), qi.cpu().numpy()     # requests arrive on the host
    mb = SERVE_MAX_BATCH
    _, batched_s = timed(lambda: [eng.retrieve_mixed(None, qi[s:s + mb], sems[s:s + mb],
                                                     q_v=qv[s:s + mb], **ef_k)
                                  for s in range(0, nq, mb)])
    queued = ServeRuntime(ServeEngine(index=idx), RuntimeConfig(max_batch=mb, max_queue=nq))
    futs = [queued.submit(q_rows[i], w_rows[i], sems[i], **ef_k) for i in range(nq)]
    t0 = time.perf_counter()
    with queued:
        for f in futs:
            f.result(timeout=600)
    prequeued_s = time.perf_counter() - t0
    emit(phase=8, part="a", card=smi, queries=nq, padded_to=bucket_batch_size(nq),
         seconds=retrieve_s, qps=nq / retrieve_s, iters=res.iters, launches=launches_a,
         padding_turns_seconds=pad_s, sync_batches_qps=nq / batched_s, prequeued_runtime_qps=nq / prequeued_s,
         checks=dict(bitwise_phase3=True, store_by_reference=True))

    # (b) the threaded runtime: single-row requests from a closed-loop
    # client, a write halfway
    before = {k: v.clone() for k, v in store_tensors(idx.store).items()}
    g = torch.Generator(device=dev).manual_seed(80)
    dels = torch.randperm(idx.n, generator=g, device=dev)[:N_SERVE_WRITE].to(torch.int32)
    dels_h = dels.cpu().numpy()
    new_x, new_iv = more_rows(N_MAIN, 0, N_SERVE_WRITE, dev)
    write_s = {}

    def submit_write(name, submit):
        """Submit a write; its seconds run from here to its future's resolution."""
        t_sub = time.perf_counter()
        fut = submit()
        fut.add_done_callback(
            lambda _: write_s.__setitem__(name, time.perf_counter() - t_sub))
        return fut

    ops.reset_launches()                                   # the serve path's run: (b)
    t0 = time.perf_counter()
    with ServeRuntime(eng, RuntimeConfig(max_batch=SERVE_MAX_BATCH)) as rt:
        futs, writes, window = [], [], collections.deque()
        for i in range(nq):
            if i == nq // 2:
                writes = [submit_write("remove", lambda: rt.submit_remove(dels_h)),
                          submit_write("upsert", lambda: rt.submit_upsert(new_x, new_iv))]
            if len(window) == SERVE_IN_FLIGHT:
                window.popleft().result(timeout=600)
            futs.append(rt.submit(q_rows[i], w_rows[i], sems[i],
                                  deadline=rt.clock() + 600.0, **ef_k))
            window.append(futs[-1])
        replies = [f.result(timeout=600) for f in futs]
        written = [w.result(timeout=60) for w in writes]
        stats = rt.stats()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    lats = np.asarray([r.latency_s for r in replies])
    p50_ms, p99_ms = 1e3 * np.percentile(lats, [50, 99], method="inverted_cdf")
    snapshots = len({id(r.index) for r in replies})
    pinned_ok = count_pinned_matches(replies, qv, qi, flags, **ef_k)
    pre = [r for r in replies if r.index is idx]
    mutated = eng.index
    post_ids = np.concatenate([r.ids for r in replies if r.index is not idx])
    post_ids = torch.as_tensor(post_ids[post_ids >= 0], device=dev).long()
    # the upsert takes the slots the remove freed: a removed id may answer
    # again, holding a new row; a removed document is its id with its old row
    reused = post_ids[torch.isin(post_ids, dels.long())]
    removed_surfaced = int((mutated.store.plane.data[reused]
                            == idx.store.plane.data[reused]).all(dim=1).sum())
    dead_surfaced = int((~mutated.alive[post_ids]).sum())
    after = store_tensors(idx.store)
    unchanged = after.keys() == before.keys() and all(bits_equal(after[k], v)
                                                      for k, v in before.items())
    emit(phase=8, part="b", card=smi, requests=nq, max_batch=SERVE_MAX_BATCH,
         in_flight=SERVE_IN_FLIGHT, qps=nq / wall, wall_seconds=wall, p50_ms=p50_ms,
         p99_ms=p99_ms, completed=stats["completed"], rejected=stats["rejected"],
         writes=stats["writes"], written=written, write_seconds=write_s,
         answered_pre_write=len(pre), snapshots=snapshots, replies_bitwise_pinned=pinned_ok,
         reused_ids_in_post_write_replies=int(reused.numel()),
         removed_documents_surfaced=removed_surfaced, dead_slots_surfaced=dead_surfaced,
         launches=launches, checks=dict(pre_write_index_unchanged=unchanged))
    check(pinned_ok == nq, f"8b: {nq - pinned_ok} replies differ from their pinned snapshot")
    check(removed_surfaced == 0 and dead_surfaced == 0,
          "8b: a removed document or a dead slot surfaced after the write")
    check(stats["rejected"] == 0 and stats["writes"] == 2 and stats["completed"] == nq
          and written == [N_SERVE_WRITE] * 2, f"8b: runtime counters off: {stats}, {written}")
    check(snapshots == 2 and 0 < len(pre) < nq, "8b: the write did not split the stream")
    check(unchanged, "8b: a write changed a tensor of the pre-write index")
    del before, after, replies, futs, eng

    # (c) the serve and updates tables on phase 3's corpus and index
    b = common.Bench(n=idx.capacity, dim=idx.store.dim, nq=nq, device=dev, cfg=idx.config,
                     corpus=(idx.x, idx.intervals), ug=idx)
    rows = tables.bench_serve(b, **SERVE_BENCH) + tables.bench_updates(b, churn=0.01)
    for r in rows:
        emit(phase=8, part="c", card=smi, row=r["name"], us_per_call=r["us_per_call"],
             derived=r["derived"], **r["metrics"])
    cons = {r["name"]: r["metrics"] for r in rows}["serve_consistency"]
    check(cons["recall_vs_pinned_snapshot"] == 1.0 and cons["recall_async_eq_sync"] == 1.0,
          f"8c: serve consistency {cons}")

    # (d) checkpoints of (b)'s mutated index
    root = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(root, ignore_errors=True)
    free_before = shutil.disk_usage(ROOT).free
    try:
        path, save_s = timed(lambda: ckpt.save_index(root / "sync", 0, mutated))
        nbytes = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
        back, restore_s = timed(lambda: ckpt.restore_index(root / "sync", device=dev))
        stores_equal = same_store(mutated, back)
        r_live = mutated.search_mixed(qv, qi, sems, **SEARCH)
        r_back = back.search_mixed(qv, qi, sems, **SEARCH)
        search_equal = same_result(r_live, r_back) and r_live.iters == r_back.iters
        saver = ckpt.AsyncCheckpointer(root / "async")
        arrays, extra = index_tree(mutated)
        t0 = time.perf_counter()
        saver.save(0, arrays, extra=extra)
        saver.wait()
        async_s = time.perf_counter() - t0
        files = sorted(f.name for f in (path / "arrays").iterdir())
        same_files = (files == sorted(f.name for f in (saver.last_path / "arrays").iterdir())
                      and all(filecmp.cmp(path / "arrays" / f, saver.last_path / "arrays" / f,
                                          shallow=False) for f in files))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(phase=8, part="d", card=smi, n_live=mutated.n, capacity=mutated.capacity,
         free_disk_bytes_before=free_before, bytes=nbytes, files=files, save_seconds=save_s,
         restore_seconds=restore_s, async_save_seconds=async_s,
         checks=dict(stores_bitwise=stores_equal, search_bitwise=search_equal,
                     async_same_files=same_files))
    check(stores_equal, "8d: the restored store differs from the saved one")
    check(search_equal, "8d: search on the restored index differs")
    check(same_files, "8d: AsyncCheckpointer wrote other files than save_index")

    # (e) the serve path ran the kernels
    for name in SERVE_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the serve path")
    emit(phase=8, part="e", launches=launches)
    return launches


def phase9_sharded(dev, main, check50, smi) -> dict:
    """The row-sharded index on the card; returns the sharded path's
    launches ((a) and (b))."""
    import dataclasses
    import datetime
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import SearchResult, UGConfig
    from repro_torch.core import intervals as iv
    from repro_torch.core.candidates import brute_force_knn
    from repro_torch.core.sharded import (
        build_sharded_index_host, build_sharded_store, make_ring_knn_fn, make_shard_probe_fns,
        make_sharded_search_fn, shard_index,
    )
    from repro_torch.distributed import ring_all_gather, ring_reduce_scatter
    from repro_torch.ft import StragglerConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharded import collective_inputs, rank_program, spawn_ranks
    from repro_torch.serve import FleetServeMonitor

    work = ROOT / "build" / "phase9"
    work.mkdir(parents=True, exist_ok=True)
    store_file = work / "nccl_store"
    store_file.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store_file}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        check(dist.get_backend() == "nccl", "phase 9: the process group is not NCCL")
        mesh = make_mesh((N_SHARDS,), ("data",), device=dev)
        idx = main["idx"]
        qv, qi, sems = main["queries"]
        nq = qv.shape[0]
        flags = iv.as_sem_flags(sems, nq, device=dev)
        x, ints = idx.x, idx.intervals

        # (a) the sharded build of phase 3's corpus with phase 3's config
        marks = {}

        def progress(msg):
            torch.cuda.synchronize()
            marks[msg.split(":")[0]] = time.perf_counter()

        ops.reset_launches()                                # (a) and (b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sidx = build_sharded_store(mesh, x, ints, idx.config, progress=progress)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = dict(ops.launches)
        st = sidx.store
        nbytes = st.memory_bytes()["total"] + sidx.global_ids.numel() * 4
        emit(phase=9, part="a", card=smi, n=idx.n, d=int(x.shape[1]), shards=N_SHARDS,
             build_seconds=build_s, ring_seconds=marks["ring"] - t0,
             attribute_seconds=marks["attribute candidates"] - marks["ring"],
             refine_seconds=marks["refinement"] - marks["attribute candidates"],
             edges=int((st.nbrs >= 0).sum()), live_cols=int(st.nbrs.shape[1]), bytes=nbytes,
             prune_sweep_launches=build_launches["prune_sweep"],
             nccl=dict(backend=dist.get_backend(), world=dist.get_world_size()))

        # (b) the mixed sharded search of phase 3's queries
        fn = make_sharded_search_fn(mesh, mixed=True, **SEARCH)
        fn(sidx, qv, qi, flags)                             # warm-up
        seconds = []
        for _ in range(TIMED_BATCHES):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ids, dist_ = fn(sidx, qv, qi, flags)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t1)
        launches = dict(ops.launches)
        res = SearchResult(ids, dist_, torch.zeros(nq, dtype=torch.int32, device=dev))
        recalls = recall_per_semantics(res, main["scored"])
        mean9 = mean(recalls.values())
        check(mean9 >= 0.02, f"9b: mean recall@10 {mean9} < 0.02 on the sharded index")
        med = statistics.median(seconds)
        emit(phase=9, part="b", card=smi, queries=nq, search_seconds=seconds, qps=nq / med,
             qps_min=nq / max(seconds), qps_max=nq / min(seconds), qps_phase3=main["qps"],
             recall_at_10=recalls, mean_recall_at_10=mean9, recall_at_10_phase3=main["recalls"],
             launches=launches)

        # (c) the checks
        out = {}
        probe_fns = make_shard_probe_fns(sidx, N_SHARDS, **SEARCH)
        parts = [p(qv, qi, flags) for p in probe_fns]
        merged_d, order = torch.sort(torch.cat([p[1] for p in parts], 1), dim=1, stable=True)
        merged_i = torch.gather(torch.cat([p[0] for p in parts], 1), 1, order[:, :SEARCH["k"]])
        check(bits_equal(merged_i, ids) and bits_equal(merged_d[:, :SEARCH["k"]], dist_),
              "9c: the sharded answer != the stable merge of the probes' answers")
        out["sharded_equals_merged_probes"] = True

        x50, ints50 = check50["idx"].x, check50["idx"].intervals
        qv50, qi50, sems50 = check50["queries"]
        sub = slice(0, 1000)
        q50 = (qv50[sub], qi50[sub], iv.as_sem_flags(sems50[sub], len(sems50[sub]), device=dev))
        cfg50 = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                         iterations=3, exact_spatial=True)
        built, seconds50, launches50 = {}, {}, {}
        for dtype, rerank in (("f32", False), ("int8", True)):
            for backend in ("cuda", "torch"):
                before = dict(ops.launches)
                s50, seconds50[f"{dtype}_{backend}"] = timed(lambda: build_sharded_store(
                    mesh, x50, ints50, cfg50, dtype=dtype, rerank=rerank, backend=backend))
                f50 = make_sharded_search_fn(mesh, mixed=True, backend=backend, plane_tag=dtype,
                                             has_rerank=rerank, **SEARCH)
                built[dtype, backend] = (s50, f50(s50, *q50))
                if backend == "cuda":
                    launches50[dtype] = {k: v - before[k] for k, v in ops.launches.items()}
            (a, ra), (b, rb) = built[dtype, "cuda"], built[dtype, "torch"]
            tensors = lambda s: [s.store.nbrs, s.store.status, s.store.plane.data, s.global_ids]
            check(all(bits_equal(u, v) for u, v in zip(tensors(a), tensors(b)))
                  and all(bits_equal(u, v) for u, v in zip(ra, rb)),
                  f"9c: sharded {dtype} build or search: kernels != plain versions")
        out["build_and_search_cuda_equals_torch"] = dict(f32=True, int8_rerank=True,
                                                         seconds=seconds50, launches=launches50)

        dev50 = built["f32", "cuda"][0]
        host50, host_s = timed(lambda: shard_index(mesh, ("data",), *build_sharded_index_host(
            x50, ints50, N_SHARDS, cfg50, device=dev)))
        scored50 = check50["scored"]
        f50 = make_sharded_search_fn(mesh, mixed=True, **SEARCH)
        q_all = (qv50, qi50, iv.as_sem_flags(sems50, len(sems50), device=dev))
        steps0 = torch.zeros(len(sems50), dtype=torch.int32, device=dev)
        r_dev, r_host = (recall_per_semantics(SearchResult(*f50(sx, *q_all), steps0), scored50)
                         for sx in (dev50, host50))
        check(all(r_dev[s] >= r_host[s] - 0.01 for s in r_dev),
              f"9c: device build recall {r_dev} below the host build's {r_host} - 0.01")
        out["recall_device_build"], out["recall_host_build"] = r_dev, r_host
        out["host_build_seconds"] = host_s

        ring_ids, ring_d = make_ring_knn_fn(mesh, k=SHARD_RING_K)(dev50.store.plane.data,
                                                                  dev50.global_ids)
        truth = brute_force_knn(x50, SHARD_RING_K)
        g = torch.Generator(device=dev).manual_seed(90)
        rows = torch.randperm(ring_ids.shape[0], generator=g, device=dev)[:SHARD_RING_SAMPLE]
        exact, ties = 0, 0
        x64 = x50.double()
        gids_s = dev50.global_ids[rows]
        ring_s = ring_ids[rows].tolist()
        truth_s = truth.ids[gids_s.clamp_min(0).long()].tolist()
        for gid, ring_row, truth_row in zip(gids_s.tolist(), ring_s, truth_s):
            if gid < 0:
                continue
            a, b = set(ring_row), set(truth_row)
            if a == b:
                exact += 1
                continue
            d64 = ((x64 - x64[gid]) ** 2).sum(1)
            kth = float(d64[list(b)].max())
            off = [float(d64[v]) for v in a ^ b]
            check(all(abs(v - kth) <= 1e-5 * kth for v in off),
                  f"9c: ring KNN of global row {gid}: {sorted(a)} != {sorted(b)}")
            ties += 1
        out["ring_rows_checked"], out["ring_rows_exact"], out["ring_rows_tied"] = (
            exact + ties, exact, ties)
        emit(phase=9, part="c", card=smi, n=int(x50.shape[0]), **out)

        # (d) SHARD_PROCS processes share the card in a gloo group
        inputs = work / "inputs.npz"
        np.savez(inputs, x=x50.cpu().numpy(), intervals=ints50.cpu().numpy(),
                 qv=q50[0].cpu().numpy(), qi=q50[1].cpu().numpy(), flags=q50[2].cpu().numpy())
        ranks = work / "ranks"
        ranks.mkdir(exist_ok=True)
        params = dict(device=f"cuda:{torch.cuda.current_device()}", shards=N_SHARDS,
                      cfg=dataclasses.asdict(cfg50), ring_k=SHARD_RING_K, **SEARCH)
        gloo_file = work / "gloo_store"
        gloo_file.unlink(missing_ok=True)
        _, procs_s = timed(lambda: spawn_ranks(rank_program, SHARD_PROCS,
                                               (str(inputs), str(ranks), params),
                                               backend="gloo", init_file=gloo_file,
                                               timeout=300.0, start="forkserver"))
        got = [dict(np.load(ranks / f"rank{r}.npz")) for r in range(SHARD_PROCS)]
        ids50, dist50 = built["f32", "cuda"][1]
        blocks, chunks = collective_inputs(mesh, "data")
        one = dict(nbrs=dev50.store.nbrs, status=dev50.store.status, gids=dev50.global_ids,
                   ring_ids=ring_ids, ring_dist=ring_d,
                   all_gather=ring_all_gather(blocks, mesh, "data")[1],
                   reduce_scatter=ring_reduce_scatter(chunks, mesh, "data"))
        for key, want in one.items():
            have = torch.as_tensor(np.concatenate([r[key] for r in got]), device=dev)
            check(bits_equal(have, want), f"9d: {key} of {SHARD_PROCS} processes != one process's")
        for r in got:
            check(bits_equal(torch.as_tensor(r["ids"], device=dev), ids50)
                  and bits_equal(torch.as_tensor(r["dist"], device=dev), dist50),
                  f"9d: the search of {SHARD_PROCS} processes != one process's")
        emit(phase=9, part="d", card=smi, processes=SHARD_PROCS, backend="gloo",
             device=params["device"], seconds=procs_s,
             checks=dict(build_bitwise=True, ring_bitwise=True, collectives_bitwise=True,
                         search_bitwise=True))

        # (e) the fleet monitor over (a)'s probe functions
        fm = FleetServeMonitor(n_shards=N_SHARDS, n_devices=2 * N_SHARDS)
        probe_q = (qv[:1000], qi[:1000], flags[:1000])
        rounds = [fm.probe(probe_fns, *probe_q) for _ in range(StragglerConfig().warmup + 4)]
        rep = fm.report()
        emit(phase=9, part="e", card=smi, probe_queries=int(probe_q[0].shape[0]),
             per_shard_seconds=rounds[-1],
             stragglers=rep["stragglers"], recommendations=rep["recommendations"],
             plan=dataclasses.asdict(rep["plan"]),
             degraded_plan=None if rep["degraded_plan"] is None
             else dataclasses.asdict(rep["degraded_plan"]))
    finally:
        dist.destroy_process_group()

    # (f) the sharded path ran the kernels
    for name in SHARD_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on the sharded path")
    emit(phase=9, part="f", card=smi, launches=launches)
    return launches


def integer_corpus(n: int, seed: int, dev):
    """Integer-valued vectors whose columns span exactly [-127, 127] (an int8
    plane then dequantizes exactly: scale 1, zero 0), every distance exact
    in f32; the corpus's own intervals and a mixed batch of integer queries."""
    import torch

    from repro_torch.data import CorpusConfig, make_corpus

    ccfg = CorpusConfig(n=n, dim=128, seed=seed)
    x, ints = make_corpus(ccfg, device=dev)
    x = torch.clamp(torch.round(x * 40), -127, 127)
    x[0], x[1] = -127.0, 127.0
    qv, qi, sems = mixed_workload(ccfg, N_LEGACY_CHECK_QUERIES, dev)
    return x, ints, (torch.clamp(torch.round(qv * 40), -127, 127), qi, sems)


def on_cpu(index):
    """The same index on the CPU (the checkpoint arrays, the entry structure
    rebuilt there)."""
    from repro_torch.core.index import host_arrays, store_from_arrays

    return index.with_store(store_from_arrays(host_arrays(index.store), index.dtype, "cpu"))


def phase10_legacy_bench(dev, main, smi) -> dict:
    """The legacy A/B backends and the rest of the bench; returns the
    launches of phase 10's paths ((a)'s check, (b) and (c))."""
    import statistics

    import torch

    from repro_torch.bench import common, run, tables
    from repro_torch.core import UGConfig, UGIndex
    from repro_torch.data import CorpusConfig, make_queries
    from repro_torch.kernels import ops

    idx = main["idx"]
    qv, qi, sems = main["queries"]
    nq = qv.shape[0]

    # (a) the legacy loop on phase 3's index and queries, beside phase 3's
    idx.search_mixed(qv, qi, sems, backend="legacy", **SEARCH)        # warm-up
    seconds = []
    for _ in range(LEGACY_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = idx.search_mixed(qv, qi, sems, backend="legacy", **SEARCH)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    recalls = recall_per_semantics(res, main["scored"])
    check(mean(recalls.values()) >= 0.02, f"10a: legacy mean recall@10 {recalls} < 0.02")
    emit(phase=10, part="a", card=smi, n=idx.n, queries=nq, backend="legacy",
         search_seconds=seconds, qps=nq / statistics.median(seconds), iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         fused=dict(qps=main["qps"], iters=main["res"].iters,
                    mean_steps=float(main["res"].steps.float().mean()),
                    recall_at_10=main["recalls"]))
    del res

    # the legacy search on the card is the same search on the CPU, on
    # integer data, on the f32 plane and on int8 + rerank with tombstones
    ops.reset_launches()                                   # phase 10's paths
    x50, ints50, (qv50, qi50, sems50) = integer_corpus(N_LEGACY_CHECK, 5, dev)
    cfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                   iterations=3)
    idx50 = UGIndex.build(x50, ints50, cfg, device=dev)
    dels = torch.randperm(N_LEGACY_CHECK, generator=torch.Generator().manual_seed(9))
    q50 = idx50.with_dtype("int8").delete(dels[: N_LEGACY_CHECK // 20].to(torch.int32),
                                           repair=False)
    check(bool((q50.store.plane.scale == 1).all() and (q50.store.plane.zero == 0).all()),
          "10a: the integer corpus does not dequantize exactly")
    cpu_q = (qv50.cpu(), qi50.cpu(), sems50)
    legacy_check = {}
    for tag, index in (("f32", idx50), ("int8_rerank_alive", q50)):
        t0 = time.perf_counter()
        card = index.search_mixed(qv50, qi50, sems50, backend="legacy", **SEARCH)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = on_cpu(index).search_mixed(*cpu_q, backend="legacy", **SEARCH)
        t_cpu = time.perf_counter() - t0
        check(same_result(result_on_cpu(card), host) and card.iters == host.iters,
              f"10a: the legacy search on the card != on the CPU ({tag})")
        legacy_check[tag] = dict(iters=card.iters, seconds_card=t_card, seconds_cpu=t_cpu)
    emit(phase=10, part="a", card=smi, n=N_LEGACY_CHECK, queries=N_LEGACY_CHECK_QUERIES,
         card_equals_cpu_bitwise=legacy_check)

    # (b) the build table at the reference's sizes: legacy, torch and cuda
    # sweeps with equal graph checksums (bench_build raises otherwise), the
    # sweeps' profiles at the build's block shape; the sharded build at 4,000
    bench_rows = {}

    def table(part, rows):
        for r in rows:
            bench_rows[r["name"]] = r
            emit(phase=10, part=part, row=r["name"], us_per_call=r["us_per_call"],
                 derived=r["derived"], **r["metrics"])

    table("b", tables.bench_build(common.BUILD_SIZES, device=dev))
    sweeps = tables.profile_backends(dev)                  # legacy, torch, cuda
    emit(phase=10, part="b", card=smi, sweeps=sweeps, sweep_peak_bytes={
        b: bench_rows[f"build_sweep_profile_{b}"]["metrics"]["peak_bytes"] for b in sweeps})

    # (c) the tables at full width on phase 3's corpus, index and queries
    ccfg = CorpusConfig(n=idx.n, dim=128, seed=0)
    batches = {w: make_queries(ccfg, nq, workload=w, device=dev) for w in ("uniform", "point")}
    b = common.Bench(n=idx.n, dim=128, nq=nq, device=dev, cfg=idx.config,
                     corpus=(idx.x, idx.intervals), ug=idx, queries=batches)
    table("c", tables.bench_beam_sweep(b))
    table("c", tables.bench_mixed_workload(b, require_speedup=2.0))
    table("c", tables.bench_memory(b, require_reduction=3.0))
    table("c", tables.bench_scalability(b, sizes=SCALE_SIZES))
    table("c", tables.bench_sensitivity(common.Bench(n=common.SENSITIVITY_N, device=dev)))
    launches = dict(ops.launches)
    for name in LEGACY_BENCH_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on phase 10's paths")
    emit(phase=10, part="c", card=smi, launches=launches)

    # (d) the bench gate: a smoke run on the card against the baseline the
    # CPU wrote; a recall that differs from the CPU's (floor + slack) is
    # printed with both values
    baseline = ROOT / "src" / "repro_torch" / "bench" / "baseline_smoke.json"
    out = ROOT / "build" / "phase10_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "--smoke", "--check", str(baseline),
         "--json", str(out)], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=SMOKE_GATE_TIMEOUT)
    gate_s = time.perf_counter() - t0
    floors = json.loads(baseline.read_text())["rows"]
    differ = {}
    for r in json.loads(out.read_text())["rows"] if out.exists() else []:
        got = run.parse_metrics(r["derived"])
        for key, floor in floors.get(r["name"], {}).get("min", {}).items():
            cpu = round(floor + run.RECALL_SLACK, 3)
            if key in got and abs(got[key] - cpu) > 5e-4:
                differ[f"{r['name']}:{key}"] = dict(card=got[key], cpu=cpu)
    regressions = [ln for ln in proc.stderr.splitlines() if "REGRESSION" in ln or "FAILED" in ln]
    emit(phase=10, part="d", card=smi, returncode=proc.returncode, seconds=gate_s,
         regressions=regressions, recall_differs_from_cpu=differ,
         gate=[ln for ln in proc.stderr.splitlines() if "perf gate" in ln])
    check(proc.returncode == 0, f"10d: the bench gate failed on the card: {regressions}\n"
                                f"{proc.stderr[-4000:]}")
    return launches


def rel_rms(a, b) -> float:
    """``‖a − b‖ / ‖b‖`` in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase11_towers(dev, smi) -> dict:
    """The LM towers on the card: reduced towers against the CPU, qwen1.5-4b
    at full width embedding the corpus the index is built over, decode,
    generate and the serve CLI; returns the launches of (c)."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import Semantics, UGConfig, UGIndex
    from repro_torch.core import intervals as iv
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import EMBED_BATCH, embed_batches
    from repro_torch.models import get_model
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serve import ServeEngine

    # (a) the five dense archs' reduced towers (float32, TF32 off) on the card
    # and on the CPU with the same weights.  Tolerance atol = rtol = 1e-4:
    # the card's BLAS sums float32 products in another order than the CPU's
    # (TF32 off), over two layers of values of order 1-4 -- the tolerance
    # the CPU tests hold the port to the reference with.
    reduced = {}
    for arch in DENSE_ARCHS:
        cfg = get_arch(arch).reduced
        model = get_model(cfg)
        host = model.init(torch.Generator().manual_seed(21))
        card = tree_map(lambda a: a.to(dev), host)
        toks = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(22))
        errs = {}
        h_cpu = model.forward(host, toks)[0]
        h_card = model.forward(card, toks.to(dev))[0].cpu()
        e_cpu = ServeEngine(model, host).embed(toks)
        e_card = ServeEngine(model, card).embed(toks.to(dev)).cpu()
        close = [torch.allclose(h_card, h_cpu, atol=1e-4, rtol=1e-4),
                 torch.allclose(e_card, e_cpu, atol=1e-4, rtol=1e-4)]
        errs["hidden"], errs["embed"] = max_abs_err(h_card, h_cpu), max_abs_err(e_card, e_cpu)
        s_cpu = model.init_decode_state(host, 2, 12)
        s_card = model.init_decode_state(card, 2, 12)
        errs["decode_logits"] = 0.0
        for i in range(12):
            s_cpu, l_cpu = model.decode_step(host, s_cpu, toks[:, i:i + 1])
            s_card, l_card = model.decode_step(card, s_card, toks[:, i:i + 1].to(dev))
            close.append(torch.allclose(l_card.cpu(), l_cpu, atol=1e-4, rtol=1e-4))
            errs["decode_logits"] = max(errs["decode_logits"], max_abs_err(l_card.cpu(), l_cpu))
        reduced[arch] = dict(max_abs_err=errs, within_tolerance=all(close))
        check(all(close), f"11a: {arch}'s reduced tower on the card != on the CPU: {errs}")
    emit(phase=11, part="a", card=smi, tolerance="atol = rtol = 1e-4", reduced_towers=reduced)

    # (b) qwen1.5-4b at full width in bf16 from a seeded generator, embedding
    # N_DOCS documents of DOC_LEN random tokens in batches of EMBED_BATCH
    cfg = get_arch(TOWER_ARCH).config
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(a.numel() for _, a in tree_leaves(params))
    check(n_params == cfg.param_count() == TOWER_PARAMS,
          f"11b: {TOWER_ARCH} has {n_params} parameters, not {TOWER_PARAMS}")
    n_body = n_params - params["embed"].numel() - params["unembed"].numel()
    engine = ServeEngine(model, params)
    g = torch.Generator(device=dev).manual_seed(1)
    docs = torch.randint(0, cfg.vocab, (N_DOCS, DOC_LEN), generator=g, device=dev)
    engine.embed(docs[:EMBED_BATCH])                       # warm-up
    x, embed_s = timed(lambda: embed_batches(engine, docs))
    tokens = N_DOCS * DOC_LEN
    norms = x.norm(dim=-1)
    unit = bool(torch.isfinite(x).all()) and float((norms - 1).abs().max()) <= 1e-5
    emit(phase=11, part="b", card=smi, arch=TOWER_ARCH, dtype=str(cfg.dtype),
         param_count=n_params, params_outside_embed_unembed=n_body, init_seconds=init_s,
         docs=N_DOCS, doc_len=DOC_LEN, batch=EMBED_BATCH, d=x.shape[1], embed_seconds=embed_s,
         tokens_per_s=tokens / embed_s, tflops=2 * n_body * tokens / embed_s / 1e12,
         peak_bf16_tflops=PEAK_BF16_PER_S / 1e12,
         bound_seconds=2 * n_body * tokens / PEAK_BF16_PER_S,
         max_norm_err=float((norms - 1).abs().max()),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         checks=dict(unit_norm=unit))
    check(unit, "11b: an embedding is not finite or not of unit norm within 1e-5")

    # (c) the index over the embeddings: the serve CLI's UGConfig (NN-descent
    # above 4,096 documents), a mixed search of embedded queries, recall
    # against brute_force; cuda == torch bitwise on the first N_TOWER_CHECK
    ops.reset_launches()                                   # (c)'s path
    ints = iv.sample_uniform_intervals(g, N_DOCS)
    ucfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                    iterations=3, repair_width=16, exact_spatial=N_DOCS <= 4096)
    idx = UGIndex.build(x, ints, ucfg, device=dev)
    qv = embed_batches(engine, torch.randint(0, cfg.vocab, (N_QUERIES, DOC_LEN), generator=g,
                                             device=dev))
    c = torch.rand((N_QUERIES, 1), generator=g, device=dev)
    wide = torch.cat([(c - 0.3).clamp_min(0.0), (c + 0.3).clamp_max(1.0)], dim=1)
    sems = [[Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF][i % 4]
            for i in range(N_QUERIES)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qi = torch.where(is_rs[:, None], torch.cat([c, c], dim=1), wide)
    idx.search_mixed(qv, qi, sems, **SEARCH)                # warm-up
    seconds = []
    for _ in range(3):
        res, s = timed(lambda: idx.search_mixed(qv, qi, sems, **SEARCH))
        seconds.append(s)
    launches = dict(ops.launches)                           # (c)'s path ends here
    med = statistics.median(seconds)
    scored = scored_queries(idx, qv, qi, sems)
    recalls = recall_per_semantics(res, scored)
    check_builds = {b: UGIndex.build(x[:N_TOWER_CHECK], ints[:N_TOWER_CHECK],
                                     dataclasses.replace(ucfg, prune_backend=b), device=dev)
                    for b in ("cuda", "torch")}
    check(bits_equal(check_builds["cuda"].graph.nbrs, check_builds["torch"].graph.nbrs)
          and bits_equal(check_builds["cuda"].graph.status, check_builds["torch"].graph.status),
          f"11c: the d = {x.shape[1]} build: prune_backend='cuda' != 'torch'")
    search_checks(check_builds["cuda"], (qv, qi, sems), dev, "11c")
    emit(phase=11, part="c", card=smi, n=N_DOCS, d=x.shape[1], queries=N_QUERIES,
         build_seconds=idx.build_seconds, degree_stats=idx.degree_stats(),
         search_seconds=seconds, qps=N_QUERIES / med,
         qps_min=N_QUERIES / max(seconds), qps_max=N_QUERIES / min(seconds), iters=res.iters,
         mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         mean_recall_at_10=mean(recalls.values()), launches=launches,
         check_builds_seconds={b: i.build_seconds for b, i in check_builds.items()},
         checks=dict(build_bitwise=True, search_bitwise=True, mixed_equals_per_semantics=True))
    check(mean(recalls.values()) >= 0.02,
          f"11c: mean recall@10 {recalls} < 0.02 over the embedded corpus")
    del idx, check_builds, res, qv, qi, x

    # (d) decode against forward at full width.  Held: the first position's
    # logits (one key: no attention choice, the paths differ by bf16
    # rounding of products over other row counts, unit roundoff 2^-8, over
    # 40 layers) within 2^-5 relative RMS; the second position's within
    # 0.15, where every layer's attention reads two cached keys, so a cache
    # written or read at the wrong slot or layer shows (the H100 read 0.055
    # here; the cache deliberately broken gave 0.33-1.35 on the CPU); and
    # the decode cache's layer 0 (every position's k and v, written step by
    # step) within 2^-6 of the prefill's.  Printed: every position's error,
    # held only below sqrt(2) (logits uncorrelated with the forward's): the
    # rounding drift grows with the position: the reference's init draws
    # wq/wk at 1/sqrt(n_heads) (its fan-in is shape[-2]), so attention is
    # near one-hot and a rounding difference can flip the key a head reads;
    # the flips compound over 40 layers (on the CPU at d = 256-512, 40
    # layers: relative RMS 0.28-0.34 in bf16, and 0.047 in the reference's
    # own float32).
    B, S = DECODE_CHECK
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    with torch.no_grad():
        hidden, caches = model.prefill(params, {"tokens": prompts})
        full = tr.unembed(cfg, params, hidden).float()
        state = model.init_decode_state(params, B, S)
        steps = []
        for i in range(S):
            state, logits = model.decode_step(params, state, prompts[:, i:i + 1])
            steps.append(logits.float())
    inc = torch.stack(steps, dim=1)
    per_pos = [rel_rms(inc[:, i], full[:, i]) for i in range(S)]
    cache0 = {name: rel_rms(state.cache[j][0].float(), caches[j][0].float())
              for j, name in enumerate(("k", "v"))}
    overall = rel_rms(inc, full)
    agree = float((inc.argmax(-1) == full.argmax(-1)).float().mean())
    emit(phase=11, part="d", card=smi, prompts=B, tokens=S, max_abs_err=max_abs_err(inc, full),
         rel_rms=overall, rel_rms_by_position=per_pos, argmax_agreement=agree,
         cache_layer0_rel_rms=cache0,
         cache_last_layer_rel_rms={name: rel_rms(state.cache[j][-1].float(),
                                                 caches[j][-1].float())
                                   for j, name in enumerate(("k", "v"))},
         tolerance=dict(first_position=2 ** -5, second_position=0.15, cache_layer0=2 ** -6,
                        all_positions=2 ** 0.5))
    check(bool(torch.isfinite(inc).all()), "11d: decode logits not finite")
    check(per_pos[0] <= 2 ** -5, f"11d: first position's decode != forward: {per_pos[0]}")
    check(per_pos[1] <= 0.15, f"11d: second position's decode != forward: {per_pos[1]}")
    check(max(cache0.values()) <= 2 ** -6, f"11d: decode cache's layer 0 != prefill's: {cache0}")
    check(overall < 2 ** 0.5, f"11d: decode logits uncorrelated with forward's: {overall}")
    del hidden, caches, full, state, inc, steps

    # (e) greedy generation
    gp = torch.randint(0, cfg.vocab, (GENERATE["prompts"], GENERATE["prompt_len"]), generator=g,
                       device=dev)
    out, gen_s = timed(lambda: engine.generate(gp, GENERATE["max_new"]))
    check(tuple(out.shape) == (GENERATE["prompts"], GENERATE["max_new"])
          and bool(((out >= 0) & (out < cfg.vocab)).all()), "11e: generate's tokens off")
    emit(phase=11, part="e", card=smi, **GENERATE, seconds=gen_s,
         new_tokens_per_s=out.numel() / gen_s,
         decode_steps_per_s=(GENERATE["prompt_len"] + GENERATE["max_new"]) / gen_s)
    del engine, params, docs, out
    torch.cuda.empty_cache()

    # (f) the serve CLI at full width in a subprocess on the card
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", TOWER_ARCH,
           "--no-reduced", "--docs", "2000", "--queries", "64", "--mixed"]
    proc, cli_s = timed(lambda: subprocess.run(
        cmd, cwd=ROOT, capture_output=True, text=True, timeout=TOWER_CLI_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))))
    emit(phase=11, part="f", card=smi, command=" ".join(cmd[1:]), returncode=proc.returncode,
         seconds=cli_s, lines=proc.stdout.splitlines())
    check(proc.returncode == 0, f"11f: the serve CLI failed:\n{proc.stderr[-4000:]}")

    # (g) (c)'s path ran the kernels
    for name in TOWER_KERNELS:
        check(launches.get(name, 0) > 0, f"{name} was not launched on phase 11's path")
    emit(phase=11, part="g", launches=launches)
    return launches


# the leaves the reference's init makes constant (tests/torch_towers.py)
ZERO_LEAVES = {"mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ffn_k", "bonus", "decay_lora_b",
               "dt_bias", "a_log"}
ONE_LEAVES = {"d_skip", "gn"}
# RWKV6's decay for phase 13 (tests/torch_towers.py::TRAIN_DECAY): a log
# decay of about -0.4 a step keeps a chunk's cumulative log well above the
# -60 clamp, so the gradient through every decay leaf is held
TRAIN_DECAY = {"decay_base": (-1.0, 0.5), "decay_lora_b": (0.0, 0.1)}


def redraw_constant_leaves(params, generator, draws=None):
    """``params`` with the leaves the init makes constant redrawn from
    ``generator`` (zeros as N(0, 0.5²), ones as 1 + N(0, 0.3²), the RWKV6
    decay base as N(0, 4²)), as the CPU tests redraw them with numpy: at
    the init's constants a dropped bonus, decay LoRA or token-shift mix
    would not show.  ``draws`` maps a leaf name to the ``(mean, std)``
    drawn in its place (phase 13: ``TRAIN_DECAY``)."""
    import torch

    draws = dict(draws or {})

    def draw(k, v, scale, shift=0.0):
        shift, scale = draws.get(k, (shift, scale))
        w = torch.randn(v.shape, generator=generator, device=v.device)
        return (shift + scale * w).to(v.dtype)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                v = walk(v)
            elif k in ZERO_LEAVES:
                v = draw(k, v, 0.5)
            elif k in ONE_LEAVES:
                v = draw(k, v, 0.3, 1.0)
            elif k == "decay_base":
                v = draw(k, v, 4.0)
            out[k] = v
        return out

    return walk(params)


@contextlib.contextmanager
def recording_router():
    """Records every MoE router call made inside the block: its expert
    choices (T, K) on the CPU and the smallest gap between the k-th and the
    (k+1)-th router probability of a token (its top-k margin)."""
    import torch

    from repro_torch.models import moe

    calls, original = [], moe._router

    def router(cfg, xt, w):
        out = original(cfg, xt, w)
        with torch.no_grad():
            probs = torch.softmax(xt.float() @ w.float(), dim=-1)
            top = probs.sort(dim=-1, descending=True).values
            margin = float((top[:, cfg.top_k - 1] - top[:, cfg.top_k]).min())
        calls.append((out[0].cpu(), margin))
        return out

    moe._router = router
    try:
        yield calls
    finally:
        moe._router = original


def decode_checks(arch, cfg, params, tokens, frames, smi) -> None:
    """Decode against forward (encdec: against ``decode_train``) of
    ``tokens`` (B, S), in bf16 and in float32 on the same weights upcast
    (TF32 off), each position's relative RMS printed, positions 0 and 1
    held within ``DECODE_TOL`` and every position below sqrt(2).  Beside
    it, position 1 decoded from a fresh state (the carry after step 0
    dropped, its position kept) must read above position 1's bound: the
    check would see a lost carry.

    Why these tolerances (H100 80GB HBM3 at 700 W, full width, the
    init's weights): a carried state dropped after step 0 reads
    1.29-1.39 at position 1 in every family.  In float32 the recurrent
    families' paths agree to 3e-6 at position 0 and 3.3e-4 (rwkv6) /
    3.5e-5 (zamba2) at position 1, so 1e-3 holds the carry itself; the
    encdec read 0.003 / 0.015 there, as its near one-hot attention (the
    init draws wq/wk at 1/sqrt(n_heads)) lets float32 rounding flip the
    key a head reads, so 2^-5 / 0.15, phase 11's decoder bounds.  In bf16
    position 0 (no history: the paths differ by bf16 rounding of products
    over other row counts through every layer) read 0.013-0.022, held
    within 2^-5; at position 1 bf16 rounding flips whole heads: RWKV6's
    per-head group norm rescales a head output (r₁·k₀)·v₀ whose sign a
    rounding can flip, and attention is near one-hot, so position 1 read
    0.11-0.48 and is held only below 1.0 (correlated), the float32 run
    being the check of the carry."""
    import dataclasses

    import torch

    from repro_torch.models import encdec, get_model
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import tree_map

    B, S = tokens.shape
    for name, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32)):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = get_model(c)
        p = tree_map(lambda a: a.to(dtype), params)
        with torch.no_grad():
            if c.family == "encdec":
                enc = encdec.encode(c, p, frames)
                full = tr.unembed(c, p, encdec.decode_train(c, p, tokens, enc)).float()
                state = model.init_decode_state((p, frames), B, S)
                del enc
            else:
                hidden, _ = model.prefill(p, {"tokens": tokens})
                full = tr.unembed(c, p, hidden).float()
                state = model.init_decode_state(p, B, S)
                del hidden
            first, _ = model.decode_step(p, state, tokens[:, :1])
            _, dropped = model.decode_step(p, state._replace(cache_len=first.cache_len),
                                           tokens[:, 1:2])
            dropped = rel_rms(dropped.float(), full[:, 1])
            per_pos, overall, agree = decode_against_forward(
                model, p, full, [tokens[:, i:i + 1] for i in range(S)], state)
        tol0, tol1 = DECODE_TOL[name][c.family]
        emit(phase=12, part="c", card=smi, arch=arch, dtype=name, batch=B, tokens=S,
             **({"frames": frames.shape[1]} if frames is not None else {}),
             rel_rms=overall, rel_rms_by_position=per_pos, argmax_agreement=agree,
             position1_with_the_carry_dropped=dropped,
             tolerance=dict(first_position=tol0, second_position=tol1,
                            all_positions=2 ** 0.5))
        check(dropped > tol1, f"12c: {arch} {name}: position 1 without the carried state "
                              f"reads {dropped}, within the bound {tol1}")
        check(per_pos[0] <= tol0, f"12c: {arch} {name}: position 0's decode != forward: "
                                  f"{per_pos[0]}")
        check(per_pos[1] <= tol1, f"12c: {arch} {name}: position 1's decode != forward: "
                                  f"{per_pos[1]}")
        check(overall < 2 ** 0.5, f"12c: {arch} {name}: decode uncorrelated with forward: "
                                  f"{overall}")
        del p, full, state
        torch.cuda.empty_cache()


def decode_against_forward(model, params, full, step_inputs, state) -> tuple:
    """Decode logits step by step from ``state`` against the forward's
    ``full`` (B, S, V): (per-position relative RMS, all positions',
    argmax agreement)."""
    import torch

    steps = []
    for tok in step_inputs:
        state, logits = model.decode_step(params, state, tok)
        steps.append(logits.float())
    inc = torch.stack(steps, dim=1)
    check(bool(torch.isfinite(inc).all()), "decode logits not finite")
    per_pos = [rel_rms(inc[:, i], full[:, i]) for i in range(full.shape[1])]
    agree = float((inc.argmax(-1) == full.argmax(-1)).float().mean())
    return per_pos, rel_rms(inc, full), agree


def phase12_families(dev, smi) -> dict:
    """The other tower families on the card: the five reduced towers against
    the CPU, rwkv6, zamba2, qwen3-moe and llama4-maverick at full width
    (embed, decode against forward, generate), seamless-m4t-medium's decode
    against ``decode_train``, the index over qwen3-moe's d = 4096
    embeddings and the serve CLI for rwkv6 and zamba2; returns the
    launches of (e)."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import Semantics, UGConfig, UGIndex
    from repro_torch.core import intervals as iv
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import EMBED_BATCH, embed_batches
    from repro_torch.models import encdec, get_model, moe
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serve import ServeEngine

    # (a) the five reduced towers (float32, TF32 off) on the card and on the
    # CPU with the same weights, the constant leaves redrawn.  Tolerance
    # atol = rtol = 1e-4, phase 11(a)'s: the card's BLAS sums float32
    # products in another order than the CPU's.  The MoE towers' expert
    # choices must be equal; the smallest top-k margin tells a genuine
    # near-tie from a fault.
    reduced = {}
    for arch in FAMILY_REDUCED:
        cfg = get_arch(arch).reduced
        model = get_model(cfg)
        host = redraw_constant_leaves(model.init(torch.Generator().manual_seed(23)),
                                      torch.Generator().manual_seed(24))
        card = tree_map(lambda a: a.to(dev), host)
        g = torch.Generator().manual_seed(25)
        toks = torch.randint(0, cfg.vocab, (2, 12), generator=g)
        frames = torch.randn((2, 6, cfg.d_model), generator=g)

        def run(params, device):
            t = toks.to(device)
            out = {}
            with torch.no_grad(), recording_router() as calls:
                if cfg.family == "encdec":
                    f = frames.to(device)
                    out["encode"] = encdec.encode(cfg, params, f)
                    out["decode_train"] = encdec.decode_train(cfg, params, t, out["encode"])
                    state = model.init_decode_state((params, f), 2, 12)
                else:
                    out["hidden"], aux, _ = model.forward(params, t)
                    out["aux"] = torch.as_tensor(aux, dtype=torch.float32)
                    out["embed"] = ServeEngine(model, params).embed(t)
                    state = model.init_decode_state(params, 2, 12)
                logits = []
                for i in range(12):
                    state, lg = model.decode_step(params, state, t[:, i:i + 1])
                    logits.append(lg)
                out["decode_logits"] = torch.stack(logits, dim=1)
            return {k: v.cpu() for k, v in out.items()}, calls

        on_cpu, calls_cpu = run(host, "cpu")
        on_card, calls_card = run(card, dev)
        errs = {k: max_abs_err(on_card[k], on_cpu[k]) for k in on_cpu}
        within = all(torch.allclose(on_card[k], on_cpu[k], atol=1e-4, rtol=1e-4)
                     for k in on_cpu)
        row = dict(max_abs_err=errs, within_tolerance=within)
        if cfg.moe:
            same = (len(calls_cpu) == len(calls_card)
                    and all(torch.equal(a, b) for (a, _), (b, _) in zip(calls_cpu, calls_card)))
            row.update(router_calls=len(calls_card), expert_choices_equal=same,
                       smallest_top_k_margin=min(m for _, m in calls_cpu + calls_card))
            check(same, f"12a: {arch}'s expert choices on the card != on the CPU: {row}")
        reduced[arch] = row
        check(within, f"12a: {arch}'s reduced tower on the card != on the CPU: {errs}")
    emit(phase=12, part="a", card=smi, tolerance="atol = rtol = 1e-4", reduced_towers=reduced)

    # (b)-(d) the full-width towers in bf16 from a seeded generator, one at a
    # time: counts, embed of N_FAMILY_DOCS documents, decode against
    # forward, generate; the INDEX_ARCH tower also embeds (e)'s queries
    kept = {}
    for arch, (cut, want_params, want_active) in FAMILY_TOWERS.items():
        cfg = get_arch(arch).config
        if cut is not None:
            cfg = dataclasses.replace(cfg, n_layers=cut)
        model = get_model(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, init_s = timed(lambda: model.init(torch.Generator(device=dev).manual_seed(0)))
        init_peak = torch.cuda.max_memory_allocated()
        n_params = sum(a.numel() for _, a in tree_leaves(params))
        active = cfg.active_param_count()
        check(n_params == cfg.param_count() == want_params and active == want_active,
              f"12b: {arch} has {n_params} parameters ({cfg.param_count()} counted, "
              f"{active} active), not {want_params} ({want_active} active)")
        n_body = active - params["embed"].numel() - params["unembed"].numel()
        engine = ServeEngine(model, params)
        g = torch.Generator(device=dev).manual_seed(1)
        docs = torch.randint(0, cfg.vocab, (N_FAMILY_DOCS, DOC_LEN), generator=g, device=dev)
        torch.cuda.reset_peak_memory_stats()
        engine.embed(docs[:EMBED_BATCH])                   # warm-up
        x, embed_s = timed(lambda: embed_batches(engine, docs))
        tokens = N_FAMILY_DOCS * DOC_LEN
        norms = x.norm(dim=-1)
        unit = bool(torch.isfinite(x).all()) and float((norms - 1).abs().max()) <= 1e-5
        emit(phase=12, part="b", card=smi, arch=arch, family=cfg.family, dtype=str(cfg.dtype),
             n_layers=cfg.n_layers, cut=FAMILY_CUTS.get(arch, "none: the whole config"),
             param_count=n_params, active_param_count=active,
             active_params_outside_embed_unembed=n_body, init_seconds=init_s,
             init_max_memory_allocated=init_peak, docs=N_FAMILY_DOCS, doc_len=DOC_LEN,
             batch=EMBED_BATCH, d=x.shape[1], embed_seconds=embed_s,
             tokens_per_s=tokens / embed_s, tflops=2 * n_body * tokens / embed_s / 1e12,
             peak_bf16_tflops=PEAK_BF16_PER_S / 1e12,
             bound_seconds=2 * n_body * tokens / PEAK_BF16_PER_S,
             **({"capacity_note": f"the experts compute every capacity slot, up to "
                                  f"capacity_factor = {cfg.capacity_factor} x the active "
                                  f"expert FLOPs counted here"} if cfg.moe else {}),
             max_norm_err=float((norms - 1).abs().max()),
             embed_max_memory_allocated=torch.cuda.max_memory_allocated(),
             checks=dict(counts_equal=True, unit_norm=unit))
        check(unit, f"12b: {arch}: an embedding is not finite or not of unit norm within 1e-5")

        # (c) decode against forward: rwkv6 and zamba2 in bf16 and float32
        # (decode_checks); MoE: the capacity depends on the tokens of the
        # call (a forward over B*S tokens drops other assignments than a
        # decode step over B), so nothing is held; the numbers and both
        # sides' drops are printed
        B, S = FAMILY_DECODE
        prompts = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
        if cfg.moe:
            with torch.no_grad(), recording_router() as calls:
                hidden, _ = model.prefill(params, {"tokens": prompts})
                full = tr.unembed(cfg, params, hidden).float()
                n_forward = len(calls)
                per_pos, overall, agree = decode_against_forward(
                    model, params, full, [prompts[:, i:i + 1] for i in range(S)],
                    model.init_decode_state(params, B, S))
            emit(phase=12, part="c", card=smi, arch=arch, dtype="bf16", batch=B, tokens=S,
                 rel_rms=overall, rel_rms_by_position=per_pos, argmax_agreement=agree,
                 held="nothing: the capacity differs between the calls",
                 dropped_assignments=dict(
                     forward=sum(moe.dropped_assignments(cfg, i) for i, _ in calls[:n_forward]),
                     decode=sum(moe.dropped_assignments(cfg, i) for i, _ in calls[n_forward:])),
                 capacity=dict(forward=moe.capacity(cfg, B * S), decode=moe.capacity(cfg, B)))
            del hidden, full
        else:
            decode_checks(arch, cfg, params, prompts, None, smi)

        # (d) greedy generation
        gp = torch.randint(0, cfg.vocab, (GENERATE["prompts"], GENERATE["prompt_len"]),
                           generator=g, device=dev)
        out, gen_s = timed(lambda: engine.generate(gp, GENERATE["max_new"]))
        check(tuple(out.shape) == (GENERATE["prompts"], GENERATE["max_new"])
              and bool(((out >= 0) & (out < cfg.vocab)).all()), f"12d: {arch}: tokens off")
        emit(phase=12, part="d", card=smi, arch=arch, **GENERATE, seconds=gen_s,
             new_tokens_per_s=out.numel() / gen_s,
             decode_steps_per_s=(GENERATE["prompt_len"] + GENERATE["max_new"]) / gen_s)
        if arch == INDEX_ARCH:
            q_tokens = torch.randint(0, cfg.vocab, (N_FAMILY_QUERIES, DOC_LEN), generator=g,
                                     device=dev)
            kept = dict(x=x, qv=embed_batches(engine, q_tokens), g=g)
        del engine, params, docs, x, out
        torch.cuda.empty_cache()

    # (c) seamless-m4t-medium at full width: ENC_FRAMES seeded frames encoded,
    # decode steps against decode_train (the reference's
    # test_encdec_decode_matches_train at full width), in bf16 and float32;
    # the cross-attention reads the same encoded K/V on both paths
    cfg = get_arch(ENCDEC_ARCH).config
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((ENC_FRAMES[0], ENC_FRAMES[1], cfg.d_model), generator=g, device=dev)
    toks = torch.randint(0, cfg.vocab, (ENC_FRAMES[0], FAMILY_DECODE[1]), generator=g,
                         device=dev)
    decode_checks(ENCDEC_ARCH, cfg, params, toks, frames, smi)
    del params, frames
    torch.cuda.empty_cache()

    # (e) the index over INDEX_ARCH's embeddings: the serve CLI's UGConfig
    # (NN-descent), a mixed search of the embedded queries, recall against
    # brute_force; cuda == torch bitwise on the first N_FAMILY_CHECK rows
    x, qv, g = kept["x"], kept["qv"], kept["g"]
    ops.reset_launches()                                   # (e)'s path
    ints = iv.sample_uniform_intervals(g, N_FAMILY_DOCS)
    ucfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                    iterations=3, repair_width=16, exact_spatial=N_FAMILY_DOCS <= 4096)
    idx = UGIndex.build(x, ints, ucfg, device=dev)
    c = torch.rand((N_FAMILY_QUERIES, 1), generator=g, device=dev)
    wide = torch.cat([(c - 0.3).clamp_min(0.0), (c + 0.3).clamp_max(1.0)], dim=1)
    sems = [[Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF][i % 4]
            for i in range(N_FAMILY_QUERIES)]
    is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
    qi = torch.where(is_rs[:, None], torch.cat([c, c], dim=1), wide)
    idx.search_mixed(qv, qi, sems, **SEARCH)                # warm-up
    seconds = []
    for _ in range(3):
        res, s = timed(lambda: idx.search_mixed(qv, qi, sems, **SEARCH))
        seconds.append(s)
    launches = {name: ops.launches.get(name, 0) for name in FAMILY_KERNELS}   # (e) ends here
    med = statistics.median(seconds)
    recalls = recall_per_semantics(res, scored_queries(idx, qv, qi, sems))
    check_builds = {b: UGIndex.build(x[:N_FAMILY_CHECK], ints[:N_FAMILY_CHECK],
                                     dataclasses.replace(ucfg, prune_backend=b), device=dev)
                    for b in ("cuda", "torch")}
    check(bits_equal(check_builds["cuda"].graph.nbrs, check_builds["torch"].graph.nbrs)
          and bits_equal(check_builds["cuda"].graph.status, check_builds["torch"].graph.status),
          f"12e: the d = {x.shape[1]} build: prune_backend='cuda' != 'torch'")
    search_checks(check_builds["cuda"], (qv, qi, sems), dev, "12e")
    emit(phase=12, part="e", card=smi, arch=INDEX_ARCH, n=N_FAMILY_DOCS, d=x.shape[1],
         queries=N_FAMILY_QUERIES, build_seconds=idx.build_seconds,
         degree_stats=idx.degree_stats(), search_seconds=seconds, qps=N_FAMILY_QUERIES / med,
         qps_min=N_FAMILY_QUERIES / max(seconds), qps_max=N_FAMILY_QUERIES / min(seconds),
         iters=res.iters, mean_steps=float(res.steps.float().mean()), recall_at_10=recalls,
         mean_recall_at_10=mean(recalls.values()), launches=launches,
         check_rows=N_FAMILY_CHECK,
         check_builds_seconds={b: i.build_seconds for b, i in check_builds.items()},
         checks=dict(build_bitwise=True, search_bitwise=True, mixed_equals_per_semantics=True))
    check(mean(recalls.values()) >= 0.02,
          f"12e: mean recall@10 {recalls} < 0.02 over {INDEX_ARCH}'s embeddings")
    for name in FAMILY_KERNELS:
        check(launches[name] > 0, f"{name} was not launched on phase 12's path")
    del idx, check_builds, res, qv, qi, x, kept
    torch.cuda.empty_cache()

    # (f) the serve CLI at full width in a subprocess on the card
    for arch in FAMILY_CLI_ARCHS:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
               "--no-reduced", "--docs", "2000", "--queries", "64", "--mixed"]
        proc, cli_s = timed(lambda: subprocess.run(
            cmd, cwd=ROOT, capture_output=True, text=True, timeout=TOWER_CLI_TIMEOUT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))))
        emit(phase=12, part="f", card=smi, command=" ".join(cmd[1:]),
             returncode=proc.returncode, seconds=cli_s, lines=proc.stdout.splitlines())
        check(proc.returncode == 0, f"12f: the serve CLI for {arch} failed:\n"
                                    f"{proc.stderr[-4000:]}")
    return launches


def tree_bits_equal(a, b) -> bool:
    """Every leaf of two trees of nested dicts bitwise equal."""
    from repro_torch.models.common import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(pa == pb and bits_equal(x, y)
                                      for (pa, x), (pb, y) in zip(la, lb))


def finish(proc, what: str, timeout=CLI_TIMEOUT) -> str:
    """The stdout of a subprocess that must exit 0 within ``timeout``."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what}: no exit within {timeout} s")
    check(proc.returncode == 0, f"{what} failed ({proc.returncode}):\n{err[-4000:]}")
    return out


def same_checkpoint(a: pathlib.Path, b: pathlib.Path) -> bool:
    """Two checkpoint steps with the same keys, cursor and array files, byte
    for byte (the manifests' write times differ)."""
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    if (ma["keys"], ma["data_cursor"], ma["step"]) != (mb["keys"], mb["data_cursor"], mb["step"]):
        return False
    return all((a / "arrays" / i["file"]).read_bytes() == (b / "arrays" / i["file"]).read_bytes()
               for i in ma["keys"].values())


def phase13_training(dev, smi) -> dict:
    """Training on the card: the ten reduced archs' losses, gradients and
    one step against the CPU; determinism, the CLI's resume and learning;
    qwen1.5-4b, rwkv6-1.6b and one qwen3-moe layer at full width; the
    trained tower's embeddings indexed and searched; the lm_steps bench.
    Returns the launches of (f)."""
    import io
    import shutil

    import torch

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import get_model
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import AdamWConfig, make_train_step, optim
    from repro_torch.train.step import deterministic, value_and_grad

    def frames_kw(cfg, seq):
        return dict(frames_dim=cfg.d_model, frames_len=seq // 2) if cfg.family == "encdec" else {}

    with deterministic(dev):
        # (a) the ten reduced archs (float32, TF32 off), the same weights and
        # batch on the card and on the CPU: loss, ce, aux, every gradient leaf,
        # and the parameters after one make_train_step.  Adam's first step is
        # lr * sign(g) where |g| >> eps, so a gradient element near zero whose
        # sign differs by rounding moves its parameter by 2 lr: the step is
        # held under AdamWConfig(eps=1e-3), where the update is smooth in g.
        # RWKV6's decay leaves are drawn as TRAIN_DECAY: with the forward
        # phases' N(0, 4^2) base the log decay reaches -exp(4) a step and the
        # chunk form's gradient through it is float32 noise
        # (tests/test_torch_grads_recurrent.py).
        B, S = TRAIN_BATCH_REDUCED
        reduced = {}
        for arch in list_archs():
            cfg = get_arch(arch).reduced
            model = get_model(cfg)
            host = redraw_constant_leaves(model.init(torch.Generator().manual_seed(41)),
                                          torch.Generator().manual_seed(42),
                                          draws=TRAIN_DECAY)
            card = tree_map(lambda a: a.to(dev), host)
            batch = lm_batch(LMDataConfig(cfg.vocab, B, S, seed=43), 0, device="cpu",
                             **frames_kw(cfg, S))
            out = {}
            for where, params in (("cpu", host), ("card", card)):
                with recording_router() as calls:
                    loss, metrics, grads = value_and_grad(
                        model, params, {k: v.to(params["embed"].device) for k, v in batch.items()})
                out[where] = dict(loss=float(loss), ce=float(metrics["ce"]),
                                  aux=float(metrics["aux"]), grads=grads, calls=calls)
            c, g = out["cpu"], out["card"]
            loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
            grad_err = {}
            for (path, gc), (_, gg) in zip(tree_leaves(c["grads"]), tree_leaves(g["grads"])):
                scale = float(gc.abs().max())
                grad_err["/".join(path)] = (max_abs_err(gg.cpu(), gc) / scale) if scale else \
                    max_abs_err(gg.cpu(), gc)
            worst_leaf = max(grad_err, key=grad_err.get)
            ocfg = AdamWConfig(**TRAIN_EPS_RULE)
            step = make_train_step(model, ocfg, donate=False)
            p_cpu, _, _ = step(host, optim.init(ocfg, host),
                               {k: v for k, v in batch.items()})
            p_card, _, _ = step(card, optim.init(ocfg, card),
                                {k: v.to(dev) for k, v in batch.items()})
            step_err = max(max_abs_err(b.cpu(), a) for (_, a), (_, b) in
                           zip(tree_leaves(p_cpu), tree_leaves(p_card)))
            rec = dict(loss_cpu=c["loss"], loss_card=g["loss"], loss_rel_err=loss_rel,
                       ce_rel_err=abs(g["ce"] - c["ce"]) / abs(c["ce"]),
                       aux_cpu=c["aux"], aux_card=g["aux"],
                       max_grad_err_over_leaf_scale=grad_err[worst_leaf], worst_leaf=worst_leaf,
                       max_param_err_after_step=step_err)
            same_experts = True
            if cfg.moe:
                same_experts = len(c["calls"]) == len(g["calls"]) and all(
                    torch.equal(a[0], b[0]) for a, b in zip(c["calls"], g["calls"]))
                rec.update(same_expert_choices=same_experts,
                           min_top_k_margin=min(m for _, m in c["calls"]))
            kind = "dense" if cfg.family == "decoder" and not cfg.moe else "moe_or_recurrent"
            rec["checks"] = dict(
                loss=loss_rel <= 1e-4 and abs(g["aux"] - c["aux"]) <= 1e-4 * max(abs(c["aux"]),
                                                                                1e-6),
                grads=grad_err[worst_leaf] <= GRAD_TOL[kind], experts=same_experts,
                step=step_err <= 1e-5)
            reduced[arch] = rec
        emit(phase=13, part="a", card=smi, batch=B, seq=S,
             tolerance=dict(loss_rel=1e-4, grad={k: f"{v} x the leaf's largest |CPU grad|"
                                                 for k, v in GRAD_TOL.items()},
                            params_after_step="1e-5 under AdamWConfig(eps=1e-3)"),
             reduced=reduced)
        bad = {a: r for a, r in reduced.items() if not all(r["checks"].values())}
        check(not bad, f"13a: on the card != on the CPU: {bad}")

        # (b) determinism, restart and learning on the card, at reduced size
        runs = {}
        for arch in DETERMINISM_ARCHS:
            cfg = get_arch(arch).reduced
            model = get_model(cfg)
            ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=DETERMINISM["steps"])
            dcfg = LMDataConfig(cfg.vocab, DETERMINISM["batch"], DETERMINISM["seq"])
            step = make_train_step(model, ocfg)
            out = []
            for _ in range(2):
                params = model.init(torch.Generator(device=dev).manual_seed(0))
                opt = optim.init(ocfg, params)
                losses = []
                for i in range(DETERMINISM["steps"]):
                    params, opt, m = step(params, opt, lm_batch(dcfg, i, device=dev,
                                                                **frames_kw(cfg, dcfg.seq)))
                    losses.append(float(m["loss"]))
                out.append((params, opt, losses))
            (p1, o1, l1), (p2, o2, l2) = out
            equal = tree_bits_equal(p1, p2) and tree_bits_equal(o1.m, o2.m) and \
                tree_bits_equal(o1.v, o2.v) and l1 == l2
            runs[arch] = dict(losses=l1, bitwise_equal=equal)
            check(equal, f"13b: two {DETERMINISM['steps']}-step runs of {arch} differ")
        drill_dir = ROOT / "build" / "train_drill"
        shutil.rmtree(drill_dir, ignore_errors=True)
        base = ["--arch", CLI_DRILL["arch"], "--reduced", "--steps", str(CLI_DRILL["steps"]),
                "--ckpt-every", str(CLI_DRILL["ckpt_every"]),
                "--batch", str(CLI_DRILL["batch"]), "--seq", str(CLI_DRILL["seq"]),
                "--log-every", "1", "--ckpt-dir", str(drill_dir / "D1")]
        final = f"step_{CLI_DRILL['steps']:09d}"
        t0 = time.perf_counter()
        lines = {}
        for what, extra in (("D1", []), ("D1 --resume", ["--resume"])):
            if extra:   # the straight run's final checkpoint goes to D2; D1 keeps step 3 of 6
                (drill_dir / "D2").mkdir()
                shutil.move(drill_dir / "D1" / final, drill_dir / "D2" / final)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_cli.main(base + extra)
            lines[what] = buf.getvalue()
            check(rc == 0, f"13b: the {what} CLI run returned {rc}")
        drill_s = time.perf_counter() - t0
        resumed = f"resumed at step {CLI_DRILL['ckpt_every']}" in lines["D1 --resume"]
        same = same_checkpoint(drill_dir / "D1" / final, drill_dir / "D2" / final)
        shutil.rmtree(drill_dir, ignore_errors=True)
        check(resumed, "13b: the resumed run did not print 'resumed at step "
                       f"{CLI_DRILL['ckpt_every']}'")
        check(same, "13b: the resumed run's final checkpoint != the straight run's")
        # microbatches 2 against 1 (a dense config: an MoE layer's capacity
        # depends on the call's tokens), the reference's 2e-5, the eps rule
        cfg = get_arch("qwen1.5-4b").reduced
        model = get_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(1))
        batch = lm_batch(LMDataConfig(cfg.vocab, 4, 32), 0, device=dev)
        ocfg = AdamWConfig(**TRAIN_EPS_RULE)
        mb = [make_train_step(model, ocfg, microbatches=k, donate=False)(
            params, optim.init(ocfg, params), batch)[0] for k in (1, 2)]
        mb_err = max(max_abs_err(a, b) for (_, a), (_, b) in
                     zip(tree_leaves(mb[0]), tree_leaves(mb[1])))
        check(mb_err <= 2e-5, f"13b: microbatches 2 against 1 differ by {mb_err}")
        # learning: LEARN's steps on one fixed batch from the CPU's weights
        cfg = get_arch(LEARN["arch"]).reduced
        model = get_model(cfg)
        params = tree_map(lambda a: a.to(dev),
                          model.init(torch.Generator().manual_seed(LEARN["seed"])))
        ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=LEARN["steps"])
        opt = optim.init(ocfg, params)
        batch = lm_batch(LMDataConfig(cfg.vocab, LEARN["batch"], LEARN["seq"]), 0, device=dev)
        step = make_train_step(model, ocfg)
        learn = []
        for _ in range(LEARN["steps"]):
            params, opt, m = step(params, opt, batch)
            learn.append(float(m["loss"]))
        emit(phase=13, part="b", card=smi, determinism=runs,
             cli_drill=dict(CLI_DRILL, seconds=drill_s, resumed_printed=resumed,
                            final_checkpoint_equal=same, lines=lines),
             microbatch_max_abs_err=mb_err, learn=dict(LEARN, losses=learn, bar=LEARN_BAR))
        check(learn[-1] < LEARN_BAR,
              f"13b: the loss after {LEARN['steps']} steps {learn[-1]} >= {LEARN_BAR}")
        del params, opt, mb

    # (c) qwen1.5-4b whole; (f), the trained tower serving, runs next, while
    # (c)'s parameters are on the card; then (d) rwkv6-1.6b and (e) one
    # qwen3-moe layer
    model, params = train_full_width("qwen1.5-4b", dev, smi)
    launches = serve_trained(dev, smi, model, params, 13, "f", "launches_training")
    del model, params
    for arch in ("rwkv6-1.6b", "qwen3-moe-235b-a22b"):
        train_full_width(arch, dev, smi)
    torch.cuda.empty_cache()

    # (g) the lm_steps bench table in a subprocess on the card
    cmd = [sys.executable, "-m", "repro_torch.bench.run", "--only", "lm_steps"]
    proc, bench_s = timed(lambda: subprocess.run(
        cmd, cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"))))
    emit(phase=13, part="g", card=smi, command=" ".join(cmd[1:]), returncode=proc.returncode,
         seconds=bench_s, lines=proc.stdout.splitlines())
    check(proc.returncode == 0, f"13g: the lm_steps bench failed:\n{proc.stderr[-4000:]}")
    check(sum(line.startswith("train_step_") for line in proc.stdout.splitlines()) == 3,
          "13g: the lm_steps bench did not print its three rows")
    return launches


def train_full_width(arch, dev, smi):
    """Phase 13 (c)-(e): ``arch`` at full width (cut per FULL_TRAIN), bf16
    from a seeded generator, float32 moments, ``launch/train``'s schedule
    for the steps run, donated steps in deterministic mode; each step's
    loss, grad norm, lr and milliseconds, tokens/s, peak memory.  Returns
    ``(model, params)`` after the steps (the caller frees them)."""
    import dataclasses
    import math
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import get_model, moe
    from repro_torch.models.common import tree_leaves
    from repro_torch.train import AdamWConfig, make_train_step, optim
    from repro_torch.train.step import deterministic

    layers, B, S, steps = FULL_TRAIN[arch]
    part = {"qwen1.5-4b": "c", "rwkv6-1.6b": "d", "qwen3-moe-235b-a22b": "e"}[arch]
    cfg = get_arch(arch).config
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with deterministic(dev):
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        n_params = sum(a.numel() for _, a in tree_leaves(params))
        n_model = n_params - params["embed"].numel()       # outside the embed lookup
        ocfg = AdamWConfig(warmup_steps=max(steps // 20, 2), total_steps=steps)
        opt = optim.init(ocfg, params)
        final_norm = "ln_out" if "ln_out" in params else "ln_f"
        probe = (params[final_norm].clone(), params["embed"][:4].clone())
        dcfg = LMDataConfig(cfg.vocab, B, S)
        step = make_train_step(model, ocfg, donate=True)
        log, dropped = [], []
        for i in range(steps):
            batch = lm_batch(dcfg, i, device=dev)
            with recording_router() as calls:
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                loss = float(m["loss"])                         # the step's sync
                ms = (time.perf_counter() - t0) * 1e3
            log.append(dict(step=i, loss=loss, grad_norm=float(m["grad_norm"]),
                            lr=float(m["lr"]), ms=ms,
                            allocated=torch.cuda.memory_allocated(),
                            peak_so_far=torch.cuda.max_memory_allocated()))
            dropped.append([moe.dropped_assignments(cfg, c[0]) for c in calls])
        del opt, step
    timed_ms = [r["ms"] for r in log[1:]] or [log[0]["ms"]]     # after the first step
    tok_s = B * S / (statistics.median(timed_ms) / 1e3)
    changed = not (torch.equal(probe[0], params[final_norm])
                   and torch.equal(probe[1], params["embed"][:4]))
    finite = all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in log)
    rec = dict(phase=13, part=part, card=smi, arch=arch, cut=TRAIN_CUTS[arch],
               n_layers=cfg.n_layers, batch=B, seq=S, dtype=str(cfg.dtype),
               param_count=n_params, steps=log, tokens_per_s=tok_s,
               tokens_per_s_from="the median step after the first",
               peak_memory_allocated=torch.cuda.max_memory_allocated(),
               checks=dict(finite=finite, params_changed=changed))
    if arch == "qwen1.5-4b":
        MEASURED["13c"] = dict(batch=B, seq=S, step_ms=[r["ms"] for r in log],
                               median_ms=statistics.median(timed_ms),
                               peak_memory_allocated=torch.cuda.max_memory_allocated())
        rec.update(model_params=n_model, model_tflops=6 * n_model * tok_s / 1e12,
                   peak_bf16_tflops=PEAK_BF16_PER_S / 1e12,
                   note="model TFLOP/s counts 6 N per token (one forward, one backward); "
                        "with remat the card runs each block's forward twice (8 N)")
        check(n_model == TRAIN_MODEL_PARAMS, f"13c: {arch} has {n_model} parameters "
                                             f"outside embed, not {TRAIN_MODEL_PARAMS}")
    if cfg.moe:
        rec.update(dropped_assignments_per_router_call=dropped,
                   note="two router calls a step: the forward and the remat recompute")
    emit(**rec)
    check(finite, f"13{part}: {arch}: a loss or grad norm is not finite: {log}")
    check(changed, f"13{part}: {arch}: the parameters did not change")
    return model, params


def serve_trained(dev, smi, model, params, phase: int, part: str, key: str) -> dict:
    """Phase 13 (f) and 14 (e): a trained tower embeds TRAIN_SERVE's
    documents and queries; UG over them (the serve CLI's UGConfig), cuda ==
    torch bitwise, a mixed search and its recall; returns the launches of
    TRAIN_KERNELS over the build and the searches, counted from 0 (printed
    under ``key``)."""
    import statistics

    import torch

    import dataclasses

    from repro_torch.core import Semantics, UGConfig, UGIndex
    from repro_torch.core import intervals as iv
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import embed_batches
    from repro_torch.serve import ServeEngine

    with torch.no_grad():
        n, nq = TRAIN_SERVE["docs"], TRAIN_SERVE["queries"]
        cfg = model.cfg
        engine = ServeEngine(model, params)
        g = torch.Generator(device=dev).manual_seed(5)
        docs = torch.randint(0, cfg.vocab, (n, DOC_LEN), generator=g, device=dev)
        x, embed_s = timed(lambda: embed_batches(engine, docs))
        norms = x.norm(dim=-1)
        unit = bool(torch.isfinite(x).all()) and float((norms - 1).abs().max()) <= 1e-5
        check(unit, f"{phase}{part}: an embedding of the trained tower is not finite or not "
                    "of unit norm")
        qv = embed_batches(engine, torch.randint(0, cfg.vocab, (nq, DOC_LEN), generator=g,
                                                 device=dev))
        ints = iv.sample_uniform_intervals(g, n)
        ucfg = UGConfig(ef_spatial=32, ef_attribute=64, max_edges_if=32, max_edges_is=32,
                        iterations=3, repair_width=16, exact_spatial=n <= 4096)
        ops.reset_launches()                               # (f)'s path
        idx = UGIndex.build(x, ints, dataclasses.replace(ucfg, prune_backend="cuda"), device=dev)
        c = torch.rand((nq, 1), generator=g, device=dev)
        wide = torch.cat([(c - 0.3).clamp_min(0.0), (c + 0.3).clamp_max(1.0)], dim=1)
        sems = [[Semantics.IF, Semantics.IS, Semantics.RS, Semantics.RF][i % 4]
                for i in range(nq)]
        is_rs = torch.tensor([s is Semantics.RS for s in sems], device=dev)
        qi = torch.where(is_rs[:, None], torch.cat([c, c], dim=1), wide)
        idx.search_mixed(qv, qi, sems, **SEARCH)            # warm-up
        seconds = []
        for _ in range(3):
            res, sec = timed(lambda: idx.search_mixed(qv, qi, sems, **SEARCH))
            seconds.append(sec)
        launches = {name: ops.launches.get(name, 0) for name in TRAIN_KERNELS}   # (f) ends
        recalls = recall_per_semantics(res, scored_queries(idx, qv, qi, sems))
        plain = UGIndex.build(x, ints, dataclasses.replace(ucfg, prune_backend="torch"),
                              device=dev)
        same = bits_equal(idx.graph.nbrs, plain.graph.nbrs) and \
            bits_equal(idx.graph.status, plain.graph.status)
        med = statistics.median(seconds)
        emit(phase=phase, part=part, card=smi, arch=cfg.name, docs=n, doc_len=DOC_LEN,
             d=x.shape[1], embed_seconds=embed_s, tokens_per_s=n * DOC_LEN / embed_s,
             max_norm_err=float((norms - 1).abs().max()), build_seconds=idx.build_seconds,
             queries=nq, search_seconds=seconds, qps=nq / med, iters=res.iters,
             recall_at_10=recalls, mean_recall_at_10=mean(recalls.values()),
             **{key: launches},
             checks=dict(unit_norm=unit, build_cuda_equals_torch=same))
        check(same, f"{phase}{part}: the build over the trained embeddings: cuda != torch")
        check(mean(recalls.values()) >= 0.02,
              f"{phase}{part}: mean recall@10 {recalls} < 0.02 over the trained tower's "
              "embeddings")
        for name in TRAIN_KERNELS:
            check(launches[name] > 0, f"{name} was not launched on phase {phase}'s path")
        del idx, plain, x, qv, engine
    torch.cuda.empty_cache()
    return launches


def phase14_mesh(dev, smi) -> dict:
    """The mesh half of training on the card (see the module docstring);
    returns the launches of (e)."""
    import dataclasses
    import io
    import math
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharded import (
        digest, ep_inputs, host_bits, run_ep_layer, run_mesh_train, spawn_ranks,
        train_rank_program,
    )
    from repro_torch.launch.shardings import block_shape, dim_axes, gather_tree, shard_tree
    from repro_torch.models import get_model, moe
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train import AdamWConfig, make_train_step, optim
    from repro_torch.train.step import deterministic

    work = ROOT / "build" / "mesh_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    B, S = MESH_BATCH
    opt_kw = dict(TRAIN_EPS_RULE)
    mesh = make_mesh(MESH_SHAPE, ("data", "model"), device=dev)

    def masked_batches(cfg):
        """MESH_STEPS lm_batches (on the CPU), their masks 80 % ones."""
        out = []
        for i in range(MESH_STEPS):
            kw = dict(frames_dim=cfg.d_model, frames_len=S // 2) if cfg.family == "encdec" else {}
            b = lm_batch(LMDataConfig(cfg.vocab, B, S, seed=53), i, device="cpu", **kw)
            mask = (torch.rand((B, S), generator=torch.Generator().manual_seed(54 + i)) < 0.8)
            mask[:, 0] = True
            b["mask"] = mask.float()
            out.append(b)
        return out

    def on(dev_, batches):
        return [{k: v.to(dev_) for k, v in b.items()} for b in batches]

    with deterministic(dev):
        # (a) one process holding every shard of (2, 2): the ten reduced archs
        reduced, kept = {}, {}
        t0 = time.perf_counter()
        for arch in list_archs():
            cfg = dataclasses.replace(get_arch(arch).reduced, dtype=torch.float32)
            model = get_model(cfg)
            host = redraw_constant_leaves(model.init(torch.Generator().manual_seed(51)),
                                          torch.Generator().manual_seed(52), draws=TRAIN_DECAY)
            batches = masked_batches(cfg)
            ocfg = AdamWConfig(**opt_kw)
            step = make_train_step(model, ocfg, donate=False)
            p1 = tree_map(lambda a: a.to(dev), host)
            o1 = optim.init(ocfg, p1)
            one, after = [], []
            for b in on(dev, batches):
                drops = None
                if cfg.moe:
                    with torch.no_grad(), recording_router() as calls:
                        model.loss(p1, b)
                    drops = sum(moe.dropped_assignments(cfg, c[0]) for c in calls)
                p1, o1, m = step(p1, o1, b)
                one.append(dict(loss=float(m["loss"]), ce=float(m["ce"]), aux=float(m["aux"]),
                                dropped=drops))
                after.append(p1)
            specs = model.specs(mesh)
            spec_of = dict(tree_leaves(specs))
            blocks = shard_tree(tree_map(lambda a: a.to(dev), host), mesh, specs)
            bad_shapes = ["/".join(path) for path, t in tree_leaves(blocks)
                          if tuple(t.shape) != block_shape(tuple(dict(tree_leaves(host))[path].shape),
                                                           mesh, spec_of[path])]
            mstep = make_train_step(model, ocfg, mesh, donate=False)
            mo = optim.init(ocfg, blocks)
            errs, mesh_m = [], []
            for b, p_one in zip(on(dev, batches), after):
                blocks, mo, m = mstep(blocks, mo, b)
                mesh_m.append({k: float(v) for k, v in m.items()})
                got = gather_tree(blocks, mesh, specs)
                errs.append(max(max_abs_err(c, a) for (_, a), (_, c) in
                                zip(tree_leaves(p_one), tree_leaves(got))))
            kind = "dense" if cfg.family == "decoder" and not cfg.moe else "moe_or_recurrent"
            rec = dict(max_param_err_by_step=errs, loss_one_device=[r["loss"] for r in one],
                       loss_mesh=[r["loss"] for r in mesh_m],
                       grad_norm_mesh=[r["grad_norm"] for r in mesh_m])
            checks = dict(params_step1=errs[0] <= MESH_PARAM_TOL[kind],
                          params_later=max(errs) <= GRAD_TOL[kind],
                          block_shapes=not bad_shapes)
            if cfg.moe:
                ce_rel = [abs(r["ce"] - o["ce"]) / abs(o["ce"]) for r, o in zip(mesh_m, one)]
                aux_rel = [abs(r["aux"] - o["aux"]) / abs(o["aux"]) for r, o in zip(mesh_m, one)]
                drops = [r["dropped"] for r in one]
                rec.update(ce_rel_err_by_step=ce_rel, aux_rel_err_by_step=aux_rel,
                           dropped_one_device=drops, dropped_mesh=[r["dropped"] for r in mesh_m])
                checks.update(ce=ce_rel[0] <= 1e-6, aux=aux_rel[0] <= 1e-6,
                              dropped=drops == [int(r["dropped"]) for r in mesh_m])
            rec["checks"] = checks
            reduced[arch] = rec
            if arch in MESH_CHECK_ARCHS:
                kept[arch] = dict(host=host, batches=batches, got=got)
            del blocks, mo, p1, o1, after
        emit(phase=14, part="a", card=smi, mesh=MESH_SHAPE, batch=B, seq=S, steps=MESH_STEPS,
             seconds=time.perf_counter() - t0,
             tolerance=dict(params_step1={k: f"{v} under AdamWConfig(eps=1e-3)"
                                          for k, v in MESH_PARAM_TOL.items()},
                            params_later={k: v for k, v in GRAD_TOL.items()},
                            moe_ce_aux_rel_step1=1e-6, dropped="equal at every step"),
             note="the one-device and the mesh step sum in other orders (the card's products "
                  "pick their algorithm by shape); step 1 starts from the same parameters, "
                  "later steps from parameters that differ by step 1's rounding, which the "
                  "reduced towers amplify as 13(a) records", reduced=reduced)
        bad = {a: r for a, r in reduced.items() if not all(r["checks"].values())}
        check(not bad, f"14a: the mesh step != the one-device step: {bad}")

        # (b) the expert-parallel MoE layer under shard_ctx.use_mesh on (2, 2)
        t0 = time.perf_counter()
        ep, ep_kept = {}, {}
        for arch in EP_ARCHS:
            base = dataclasses.replace(get_arch(arch).reduced, dtype=torch.float32)
            for cf in (16.0, base.capacity_factor):
                cfg = dataclasses.replace(base, capacity_factor=cf)
                layer, x, g = ep_inputs(cfg, *EP_SHAPE, seed=61, dev=dev)
                res, elog = run_ep_layer(cfg, mesh, layer, x, g)
                live = tree_map(lambda a: a.detach().clone().requires_grad_(True), layer)
                xl = x.detach().clone().requires_grad_(True)
                with torch.enable_grad(), recording_router() as calls:
                    y0, a0 = moe._moe_ffn_local(cfg, live, xl)
                    (dx0,) = torch.autograd.grad(torch.sum(y0.float() * g.float()) + a0, [xl])
                rec = dict(capacity_factor=cf, dropped_ep=elog["dropped"],
                           dropped_local=moe.dropped_assignments(cfg, calls[0][0]),
                           y_err=max_abs_err(res["y"], y0.detach()),
                           dx_err=max_abs_err(res["dx"], dx0),
                           aux_ep=float(res["aux"]), aux_local=float(a0.detach()),
                           seconds=elog["seconds"])
                ep[f"{arch} cf {cf}"] = rec
                if cf == 16.0:
                    check(rec["y_err"] <= EP_TOL and rec["dx_err"] <= EP_TOL,
                          f"14b: {arch}: EP != local (y {rec['y_err']}, dx {rec['dx_err']})")
                    ep_kept[arch] = dict(cfg=cfg, layer=layer, x=x, g=g, res=res)
        emit(phase=14, part="b", card=smi, mesh=MESH_SHAPE, shape=EP_SHAPE, tolerance=EP_TOL,
             seconds=time.perf_counter() - t0, layers=ep)

    # (c) two gloo processes sharing the card: the same steps and EP calls
    t0 = time.perf_counter()
    jobs, arrays, want = [], {}, {}
    for arch in MESH_CHECK_ARCHS:
        k = kept[arch]
        model = get_model(dataclasses.replace(get_arch(arch).reduced, dtype=torch.float32))
        for shape in ((2, 2), (2, 1), (1, 2)):
            name = f"{arch}@{shape[0]}x{shape[1]}"
            jobs.append(dict(name=name, kind="train", arch=arch, reduced=True, dtype="float32",
                             mesh=shape, opt=opt_kw, steps=MESH_STEPS))
            for path, t in tree_leaves(k["host"]):
                arrays[f"{name}/p/" + "/".join(path)] = t.numpy()
            for i, b in enumerate(k["batches"]):
                for key in ("tokens", "labels", "mask"):
                    arrays[f"{name}/b{i}/{key}"] = b[key].numpy()
            if shape == MESH_SHAPE:
                got = k["got"]                          # (a)'s one-process result
            else:
                with deterministic(dev):
                    blocks, _, _ = run_mesh_train(
                        model, make_mesh(shape, ("data", "model"), device=dev),
                        tree_map(lambda a: a.to(dev), k["host"]), on(dev, k["batches"]), opt_kw)
                got = blocks                            # one process: the blocks are whole
            for path, t in tree_leaves(got):
                want[f"{name}/p/" + "/".join(path)] = host_bits(t)
    for arch in EP_ARCHS:
        k, name = ep_kept[arch], f"ep-{arch}"
        jobs.append(dict(name=name, kind="ep", cfg=dataclasses.asdict(k["cfg"]), dtype="float32",
                         mesh=(MESH_SHAPE, ("data", "model"))))
        for path, t in tree_leaves(k["layer"]):
            arrays[f"{name}/ep/" + "/".join(path)] = t.cpu().numpy()
        arrays[f"{name}/x"], arrays[f"{name}/g"] = k["x"].cpu().numpy(), k["g"].cpu().numpy()
        for key, t in k["res"].items():
            want[f"{name}/{key}"] = host_bits(t)
    np.savez(work / "inputs_c.npz", **arrays)
    (work / "c").mkdir()
    spawn_ranks(train_rank_program, MESH_PROCS,
                (str(work / "inputs_c.npz"), str(work / "c"),
                 dict(device="cuda", threads=max(1, (os.cpu_count() or 2) // MESH_PROCS),
                      save="arrays", jobs=jobs)),
                backend="gloo", init_file=work / "init_c", timeout=MESH_SPAWN_TIMEOUT,
                start="forkserver")
    ranks = np.load(work / "c" / "rank0.npz")
    differ = sorted(k for k in want if not np.array_equal(ranks[k], want[k]))
    emit(phase=14, part="c", card=smi, procs=MESH_PROCS, jobs=[j["name"] for j in jobs],
         arrays_compared=len(want), arrays_differing=differ[:20],
         seconds=time.perf_counter() - t0)
    check(not differ, f"14c: {len(differ)} arrays of the gloo ranks != one process's: {differ[:5]}")

    # (d) full width: rwkv6-1.6b's mesh steps and qwen3-moe's EP layer in two
    # gloo processes, then one process holding every shard of the same meshes
    t0 = time.perf_counter()
    steps = MESH_FULL["steps"]
    full_opt = dict(warmup_steps=max(steps // 20, 2), total_steps=steps)
    ecfg = dataclasses.replace(get_arch(EP_FULL["arch"]).config, n_layers=1,
                               dtype=torch.bfloat16)
    jobs = [dict(name="rwkv", kind="train", arch=MESH_FULL["arch"], reduced=False,
                 dtype="bfloat16", mesh=MESH_FULL["mesh"], opt=full_opt, steps=steps,
                 batch=MESH_FULL["batch"], seq=MESH_FULL["seq"], seed=0, moments=False),
            dict(name="ep", kind="ep", cfg=dataclasses.asdict(ecfg), dtype="bfloat16",
                 mesh=(EP_FULL["mesh"], ("data", "model")), B=EP_FULL["B"], S=EP_FULL["S"],
                 seed=0)]
    (work / "d").mkdir()
    torch.cuda.empty_cache()
    spawn_ranks(train_rank_program, MESH_PROCS,
                (None, str(work / "d"),
                 dict(device="cuda", threads=max(1, (os.cpu_count() or 2) // MESH_PROCS),
                      save="digests", jobs=jobs)),
                backend="gloo", init_file=work / "init_d", timeout=MESH_SPAWN_TIMEOUT,
                start="forkserver")
    spawn_s = time.perf_counter() - t0
    logs = [json.loads((work / "d" / f"rank{r}.json").read_text()) for r in range(MESH_PROCS)]
    sums = np.load(work / "d" / "rank0.npz")

    cfg = dataclasses.replace(get_arch(MESH_FULL["arch"]).config, dtype=torch.bfloat16)
    model = get_model(cfg)
    n_params = cfg.param_count()
    one_device_bytes = dict(params=n_params * 2, moments=n_params * 4 * 2)
    # what a process holds: each leaf split over "data" by its spec, whole otherwise
    # (a dimension that does not divide stays whole, as in the reference)
    held = sum(t.numel() // (MESH_PROCS if any("data" in a for a in dim_axes(spec, t.dim()))
                             else 1)
               for (_, t), (_, spec) in zip(tree_leaves(model.shapes()), tree_leaves(
                   model.specs(make_mesh(MESH_FULL["mesh"], ("data", "model"), device=dev)))))
    held_bytes = dict(params=held * 2, moments=held * 4 * 2)
    Bf, Sf = MESH_FULL["batch"], MESH_FULL["seq"]
    with deterministic(dev):
        torch.cuda.reset_peak_memory_stats()
        init = model.init(torch.Generator(device=dev).manual_seed(0))
        probe = (init["ln_out"].clone(), init["embed"][:4].clone())
        dcfg = LMDataConfig(cfg.vocab, Bf, Sf)
        mesh_d = make_mesh(MESH_FULL["mesh"], ("data", "model"), device=dev)
        blocks, opt, log1 = run_mesh_train(model, mesh_d, init,
                                           [lm_batch(dcfg, i, device=dev) for i in range(steps)],
                                           full_opt)
        del init
        one_peak = torch.cuda.max_memory_allocated()
        trained = gather_tree(blocks, mesh_d, model.specs(mesh_d))
        mine = {"rwkv/p/" + "/".join(path): digest(t) for path, t in tree_leaves(trained)}
        del opt
    changed = not (torch.equal(probe[0], trained["ln_out"])
                   and torch.equal(probe[1], trained["embed"][:4]))
    same = all(str(sums[k]) == v for k, v in mine.items())
    per_proc = []
    for r, lg in enumerate(logs):
        t = lg["rwkv"]
        med = sorted(t["seconds"][1:])[len(t["seconds"][1:]) // 2] if steps > 1 else t["seconds"][0]
        coll = t["collective_seconds"]
        per_proc.append(dict(
            rank=r, peak_memory_allocated=t.get("peak_memory_allocated"),
            param_bytes=t["param_bytes"], moment_bytes=t["moment_bytes"],
            ms_per_step=[x * 1e3 for x in t["seconds"]],
            collective_ms=[x * 1e3 for x in coll],
            compute_ms=[(x - c) * 1e3 for x, c in zip(t["seconds"], coll)],
            tokens_per_s=Bf * Sf / med, loss=t["loss"], grad_norm=t["grad_norm"]))
    MEASURED["14d"] = [dict(rank=r, collective_s=lg["rwkv"]["collective_seconds"],
                            collective_bytes=lg["rwkv"]["collective_bytes"],
                            ep_seconds=lg["ep"]["seconds"],
                            ep_collective_bytes=lg["ep"]["collective_bytes"])
                       for r, lg in enumerate(logs)]
    finite = all(math.isfinite(v) for p in per_proc for v in p["loss"] + p["grad_norm"])
    half = all(p["param_bytes"] == held_bytes["params"]
               and p["moment_bytes"] == held_bytes["moments"] for p in per_proc)
    emit(phase=14, part="d", card=smi, arch=MESH_FULL["arch"], mesh=MESH_FULL["mesh"],
         procs=MESH_PROCS, batch=Bf, seq=Sf, steps=steps, spawn_seconds=spawn_s,
         one_device_bytes=one_device_bytes, held_bytes_by_specs=held_bytes,
         held_fraction=held_bytes["params"] / one_device_bytes["params"], per_process=per_proc,
         one_process=dict(ms_per_step=[x * 1e3 for x in log1["seconds"]],
                          collective_ms=[x * 1e3 for x in log1["collective_seconds"]],
                          loss=log1["loss"], peak_memory_allocated=one_peak),
         checks=dict(finite=finite, params_changed=changed, held_bytes_half=half,
                     gathered_bitwise_one_process=same))
    check(finite and changed and half, f"14d: {MESH_FULL['arch']}: finite {finite}, "
                                       f"changed {changed}, the bytes the specs give {half}")
    check(same, f"14d: {MESH_FULL['arch']}: the gloo ranks' parameters != one process's")

    # (e) the trained rwkv6 serves, while its weights are on the card
    launches = serve_trained(dev, smi, model, trained, 14, "e", "launches_mesh")
    del trained, blocks
    torch.cuda.empty_cache()

    # (d) continued: qwen3-moe's EP layer at full width, one process holding both shards
    with deterministic(dev):
        mesh_e = make_mesh(EP_FULL["mesh"], ("data", "model"), device=dev)
        layer, x, g = ep_inputs(ecfg, EP_FULL["B"], EP_FULL["S"], 0, dev)
        res, elog = run_ep_layer(ecfg, mesh_e, layer, x, g)
        del layer
        ep_same = all(str(sums[f"ep/{k}"]) == digest(t) for k, t in res.items())
    del res
    torch.cuda.empty_cache()
    emit(phase=14, part="d", layer=f"{EP_FULL['arch']} MoE", card=smi, mesh=EP_FULL["mesh"],
         procs=MESH_PROCS, B=EP_FULL["B"], S=EP_FULL["S"], experts=ecfg.n_experts,
         top_k=ecfg.top_k, d_model=ecfg.d_model,
         per_process=[dict(rank=r, ms=lg["ep"]["seconds"] * 1e3,
                           all_to_all_bytes_sent=lg["ep"]["all_to_all_bytes_sent"],
                           dropped=lg["ep"]["dropped"],
                           peak_memory_allocated=lg["ep"].get("peak_memory_allocated"))
                      for r, lg in enumerate(logs)],
         one_process=dict(ms=elog["seconds"] * 1e3, dropped=elog["dropped"]),
         checks=dict(bitwise_one_process=ep_same), seconds=time.perf_counter() - t0)
    check(ep_same, "14d: the EP layer's gloo ranks != one process holding both shards")

    # (f) the CLI in this process: a straight --mesh 2x2 run, its final
    # checkpoint moved away, resumed on --mesh 1x2
    t0 = time.perf_counter()
    drill = work / "cli"
    c = MESH_CLI
    base = ["--arch", c["arch"], "--reduced", "--steps", str(c["steps"]),
            "--ckpt-every", str(c["ckpt_every"]), "--batch", str(c["batch"]),
            "--seq", str(c["seq"]), "--log-every", "1", "--ckpt-dir", str(drill / "D1")]
    final = f"step_{c['steps']:09d}"
    out = {}
    for what, extra in (("straight", ["--mesh", c["mesh"]]),
                        ("resumed", ["--mesh", c["resume_mesh"], "--resume"])):
        if what == "resumed":
            (drill / "D2").mkdir()
            shutil.move(drill / "D1" / final, drill / "D2" / final)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(base + extra)
        out[what] = buf.getvalue().splitlines()
        check(rc == 0, f"14f: the {what} CLI run returned {rc}")
    resumed = any(f"resumed at step {c['ckpt_every']}" in line for line in out["resumed"])
    meta = json.loads((drill / "D1" / final / "manifest.json").read_text())
    worst = 0.0
    for key, info in meta["keys"].items():
        if key.startswith("params/"):
            a = np.load(drill / "D1" / final / "arrays" / info["file"]).astype(np.float64)
            b = np.load(drill / "D2" / final / "arrays" / info["file"]).astype(np.float64)
            worst = max(worst, float(np.abs(a - b).max()))
    emit(phase=14, part="f", card=smi, drill=c, resumed_printed=resumed,
         max_param_err=worst, tolerance=MESH_CLI_TOL, lines=out,
         seconds=time.perf_counter() - t0)
    check(resumed, f"14f: the resumed run did not print 'resumed at step {c['ckpt_every']}'")
    check(worst <= MESH_CLI_TOL, f"14f: resumed on {c['resume_mesh']} differs from the straight "
                                 f"run by {worst}")
    shutil.rmtree(work, ignore_errors=True)
    return launches


def phase15_dryrun(dev, smi) -> dict:
    """The dry-run, its tally and the roofline on the card (see the module
    docstring); returns the launches of (d)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.hlo_analysis import ep_layer_collectives, mesh_step_collectives
    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.models import get_model


    # (a) three cells through the CLI, the three subprocesses side by side
    # while (b)-(d) run here
    t_a = time.perf_counter()
    work = ROOT / "build" / "dryrun_phase"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (arch, shape) in enumerate(DRYRUN_CELLS):
        out = work / f"cell{i}.jsonl"
        out.unlink(missing_ok=True)
        cell = ["--index-cell"] if arch is None else ["--arch", arch, "--shape", shape]
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *cell, "--mesh", "single",
               "--out", str(out)]
        procs.append((cmd, out, subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))))

    # (b) 13(c)'s cell counted on meta, its terms beside 13(c)'s measured step
    t0 = time.perf_counter()
    m13 = MEASURED["13c"]
    shape = ShapeSpec("train_13c", m13["seq"], m13["batch"], "train")
    rec = dryrun.run_cell("qwen1.5-4b", shape, "1x1", verbose=False,
                          mesh=make_mesh((1, 1), ("data", "model"), device="meta"))
    check(rec["ok"], f"15b: {rec.get('error')}")
    t = roofline.analyze(rec)
    bound = max(t["t_compute_s"], t["t_memory_s"], t["t_collective_s"])
    n_model = get_arch("qwen1.5-4b").config.param_count()
    model_flops = 6 * n_model * m13["batch"] * m13["seq"]
    measured_s = m13["median_ms"] / 1e3
    emit(phase=15, part="b", card=smi, cell="qwen1.5-4b whole, B = %d, S = %d, (1, 1) mesh"
         % (m13["batch"], m13["seq"]), flops=rec["flops"], bytes_accessed=rec["bytes_accessed"],
         collective_bytes=rec["collective_bytes"],
         **{k: t[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s", "dominant")},
         mem_argument=rec["mem"]["argument"], top_ops=rec["top_ops"],
         measured_median_ms=m13["median_ms"], measured_step_ms=m13["step_ms"],
         measured_peak_memory_allocated=m13["peak_memory_allocated"],
         temp_stand_in="peak memory allocated of the measured step (no compiler's temp)",
         model_flops=model_flops, bound_over_measured=bound / measured_s,
         model_flops_fraction=model_flops / roofline.PEAK_FLOPS / measured_s,
         seconds=time.perf_counter() - t0)

    # (c) 14(d)'s rwkv6 step and EP layer: the plan's collective bytes a
    # process beside what its collectives counted and their measured seconds
    cfg = dataclasses.replace(get_arch(MESH_FULL["arch"]).config, dtype=torch.bfloat16)
    ecfg = dataclasses.replace(get_arch(EP_FULL["arch"]).config, n_layers=1,
                               dtype=torch.bfloat16)
    for m in MEASURED["14d"]:
        mesh = Mesh(MESH_FULL["mesh"], ("data", "model"), torch.device("cpu"),
                    (MESH_PROCS, 1), (m["rank"], 0), {})
        plan = mesh_step_collectives(get_model(cfg), mesh).stats()
        mesh_e = Mesh(EP_FULL["mesh"], ("data", "model"), torch.device("cpu"),
                      (1, MESH_PROCS), (0, m["rank"]), {})
        ep_plan = ep_layer_collectives(ecfg, mesh_e, EP_FULL["B"], EP_FULL["S"]).stats()
        coll_s = m["collective_s"]
        emit(phase=15, part="c", card=smi, rank=m["rank"], plan_bytes=plan.total_bytes,
             plan_by_type=plan.by_type, plan_by_part=plan.by_computation,
             counted_bytes=m["collective_bytes"], collective_s=coll_s,
             achieved_gb_per_s=[plan.total_bytes / x / 1e9 for x in coll_s],
             ep_plan_by_type=ep_plan.by_type, ep_counted_bytes=m["ep_collective_bytes"],
             ep_seconds=m["ep_seconds"])
        check(all(c == plan.by_type for c in m["collective_bytes"]),
              f"15c: rank {m['rank']}: counted {m['collective_bytes']} != plan {plan.by_type}")
        check(m["ep_collective_bytes"] == ep_plan.by_type,
              f"15c: rank {m['rank']}: the EP layer counted {m['ep_collective_bytes']} "
              f"!= plan {ep_plan.by_type}")

    # (d) the index cell's step on the card, counted from 0, and on the CPU
    t0 = time.perf_counter()
    mesh = make_mesh((16, 16), ("data", "model"), device=dev)
    ops.reset_launches()
    card, _, mem, plan, (ids, dist) = dryrun.count_index_cell(mesh, device=dev)
    torch.cuda.synchronize()
    launches = {name: ops.launches.get(name, 0) for name in DRYRUN_KERNELS}
    card_s = time.perf_counter() - t0
    plain, _, _, _, (ids_p, dist_p) = dryrun.count_index_cell(mesh, device="cpu")
    same = (card.flops, card.ops, card.hbm_bytes, dict(card.kernels), dict(card.by_op)) == \
        (plain.flops, plain.ops, plain.hbm_bytes, dict(plain.kernels), dict(plain.by_op))
    # the kernels' results at the cell's shapes: the two-iteration step's
    # ids and distances, the card's against the plain versions' on the CPU
    found = int((ids >= 0).sum())
    bitwise = bits_equal(ids.cpu(), ids_p) and bits_equal(dist.cpu(), dist_p)
    emit(phase=15, part="d", card=smi, launches=launches, flops=card.flops,
         other_ops=card.ops, hbm_bytes=card.hbm_bytes, kernels=card.top("kernels"), mem=mem,
         collective_bytes=plan.stats().total_bytes, card_equals_cpu=same,
         results_bitwise_cpu=bitwise, results_found=found,
         max_abs_err=max_abs_err(dist.cpu(), dist_p), card_seconds=card_s,
         seconds=time.perf_counter() - t0)
    check(all(v > 0 for v in launches.values()), f"15d: a kernel did not launch: {launches}")
    check(same, "15d: the index cell's tally on the card != its plain versions' on the CPU: "
                f"{card.flops, card.ops, card.hbm_bytes, dict(card.kernels)} != "
                f"{plain.flops, plain.ops, plain.hbm_bytes, dict(plain.kernels)}")
    check(found > 0 and bool(torch.isfinite(dist[ids >= 0]).all()),
          f"15d: the index cell's step found {found} results, or distances not finite")
    check(bitwise, "15d: the index cell's ids and distances on the card != the plain "
                   "versions' on the CPU")

    for cmd, out, proc in procs:           # (a)
        finish(proc, "15a: " + " ".join(cmd[3:]), timeout=DRYRUN_TIMEOUT)
        rec = json.loads(out.read_text().splitlines()[-1])
        check(rec["ok"] and not rec.get("skipped"), f"15a: {rec.get('error')}")
        emit(phase=15, part="a", card=smi, command=" ".join(cmd[3:]), record=rec,
             roofline=roofline.analyze(rec), seconds=time.perf_counter() - t_a)
    return launches


def phase16_tensor_parallel(dev, smi) -> None:
    """Tensor parallelism at full width on the card (see the module
    docstring)."""
    import dataclasses
    import math
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.hlo_analysis import mesh_step_collectives
    from repro_torch.launch.mesh import Mesh, _process_grid
    from repro_torch.launch.sharded import spawn_ranks, tp_check_rank
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    work = ROOT / "build" / "tp_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    c = TP_FULL
    torch.cuda.empty_cache()
    wall = time.time()
    spawn_ranks(tp_check_rank, MESH_PROCS,
                (str(work), dict(c, opt=TRAIN_EPS_RULE, device="cuda",
                                 threads=max(1, (os.cpu_count() or 2) // MESH_PROCS))),
                backend="gloo", init_file=work / "init", timeout=TP_SPAWN_TIMEOUT,
                start="forkserver")
    spawn_s = time.perf_counter() - t0
    logs = [json.loads((work / f"rank{r}.json").read_text()) for r in range(MESH_PROCS)]
    procs = _process_grid(c["mesh"], MESH_PROCS)
    runs, bad = [], {}
    for i, want in enumerate(c["runs"]):
        dtype = want["dtype"]
        model = get_model(dataclasses.replace(get_arch(c["arch"]).config, n_layers=c["layers"],
                                              dtype=getattr(torch, dtype)))
        per = []
        for r, lg in enumerate(logs):
            run = lg["runs"][i]
            coords = tuple(int(x) for x in divmod(r, procs[1]))
            plan = mesh_step_collectives(model, Mesh(c["mesh"], ("data", "model"),
                                                     torch.device("cpu"), procs, coords, {}),
                                         batch=(c["batch"], c["seq"])).stats().by_type
            one = run if want["params"] else logs[0]["runs"][i]   # bf16: rank 0 ran it
            rel = {k: abs(run[k][0] - one[f"one_device_{k}"]) / abs(one[f"one_device_{k}"])
                   for k in ("loss", "grad_norm")}
            ratio = run["peak_memory_allocated"] / one["one_device_peak_memory_allocated"]
            checks = dict(dtype=run["dtype"] == dtype,
                          step1_vs_one_device=all(v <= TP_METRIC_TOL[dtype]
                                                  for v in rel.values()),
                          plan=all(b == plan for b in run["collective_bytes"]),
                          finite=all(math.isfinite(v) for v in run["loss"] + run["grad_norm"]))
            if want["params"]:
                checks.update(params_step1=run["max_param_err"] <= TP_PARAM_TOL,
                              peak=ratio <= TP_PEAK_RATIO)
            per.append(dict(
                rank=r, peak_memory_allocated=run["peak_memory_allocated"],
                one_device_peak_memory_allocated=one["one_device_peak_memory_allocated"],
                peak_ratio=ratio, param_bytes=run["param_bytes"],
                max_param_err=run["max_param_err"],
                ms_per_step=[x * 1e3 for x in run["seconds"]],
                collective_ms=[{k.replace("_s", "_ms"): v * 1e3 for k, v in t.items()}
                               for t in run["timing"]],
                tokens_per_s=[c["batch"] * c["seq"] / x for x in run["seconds"]],
                loss=run["loss"], grad_norm=run["grad_norm"],
                one_device_loss=one["one_device_loss"],
                one_device_grad_norm=one["one_device_grad_norm"], rel_err_step1=rel,
                collective_bytes=run["collective_bytes"], plan_by_type=plan, checks=checks))
            if not all(checks.values()):
                bad[f"{dtype} rank {r}"] = checks
        same = all(p["loss"] == per[0]["loss"] and p["grad_norm"] == per[0]["grad_norm"]
                   for p in per)
        if not same:
            bad[f"{dtype} ranks"] = "the processes report different losses or grad norms"
        runs.append(dict(dtype=dtype, steps=want["steps"], params=model.cfg.param_count(),
                         per_process=per, ranks_agree=same))
    emit(phase=16, card=smi, arch=c["arch"], layers=c["layers"], mesh=c["mesh"],
         procs=MESH_PROCS, batch=c["batch"], seq=c["seq"], cut=TRAIN_CUTS[c["arch"]],
         tolerance=dict(params_step1=f"float32 {TP_PARAM_TOL} under AdamWConfig(eps=1e-3)",
                        step1_loss_and_grad_norm_rel=TP_METRIC_TOL,
                        peak_ratio=f"float32 {TP_PEAK_RATIO}"),
         runs=runs, seconds_at=[lg["marks"] for lg in logs],
         started_after_s=[lg["started_at"] - wall for lg in logs], spawn_seconds=spawn_s,
         seconds=time.perf_counter() - t0)
    check(not bad, f"16: the tensor-parallel step's checks failed: {bad}")
    shutil.rmtree(work, ignore_errors=True)


def phase17_moe_tensor_parallel(dev, smi) -> None:
    """The MoE archs' split along ``model`` at full width on the card (see
    the module docstring)."""
    import dataclasses
    import math
    import shutil

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.hlo_analysis import mesh_step_collectives
    from repro_torch.launch.mesh import Mesh, _process_grid
    from repro_torch.launch.sharded import spawn_ranks, tp_check_rank, tp_reference
    from repro_torch.models import get_model

    t0 = time.perf_counter()
    work = ROOT / "build" / "moe_tp_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    c = MOE_TP_FULL
    (want,) = c["runs"]
    run = dict(want, reference=str(work / "one_device.pt"))
    params = dict(c, runs=[run], opt=TRAIN_EPS_RULE, device="cuda",
                  threads=max(1, (os.cpu_count() or 2) // MESH_PROCS))
    torch.cuda.empty_cache()
    ref = tp_reference(params, run, run["reference"])    # first, alone on the card
    ref_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    wall = time.time()
    spawn_ranks(tp_check_rank, MESH_PROCS, (str(work), params), backend="gloo",
                init_file=work / "init", timeout=TP_SPAWN_TIMEOUT, start="forkserver")
    spawn_s = time.perf_counter() - t0 - ref_s
    logs = [json.loads((work / f"rank{r}.json").read_text()) for r in range(MESH_PROCS)]
    procs = _process_grid(c["mesh"], MESH_PROCS)
    model = get_model(dataclasses.replace(get_arch(c["arch"]).config, n_layers=c["layers"],
                                          dtype=getattr(torch, want["dtype"])))
    per, bad = [], {}
    for r, lg in enumerate(logs):
        (got,) = lg["runs"]
        coords = tuple(int(x) for x in divmod(r, procs[1]))
        plan = mesh_step_collectives(model, Mesh(c["mesh"], ("data", "model"),
                                                 torch.device("cpu"), procs, coords, {}),
                                     batch=(c["batch"], c["seq"])).stats().by_type
        rel = {k: abs(got[k][0] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm", "aux")}
        checks = dict(params_step1=got["max_param_err"] <= TP_PARAM_TOL,
                      step1_vs_one_device=all(rel[k] <= TP_METRIC_TOL[want["dtype"]]
                                              for k in ("loss", "grad_norm")),
                      dropped=int(got["dropped"][0]) == ref["dropped"],
                      plan=all(b == plan for b in got["collective_bytes"]),
                      finite=all(math.isfinite(v) for v in got["loss"] + got["grad_norm"]))
        per.append(dict(
            rank=r, peak_memory_allocated=got["peak_memory_allocated"],
            peak_ratio=got["peak_memory_allocated"] / ref["peak_memory_allocated"],
            param_bytes=got["param_bytes"], max_param_err=got["max_param_err"],
            ms_per_step=[x * 1e3 for x in got["seconds"]],
            collective_ms=[{k.replace("_s", "_ms"): v * 1e3 for k, v in t.items()}
                           for t in got["timing"]],
            tokens_per_s=[c["batch"] * c["seq"] / x for x in got["seconds"]],
            loss=got["loss"], grad_norm=got["grad_norm"], aux=got["aux"],
            dropped=got["dropped"], rel_err_step1=rel, collective_bytes=got["collective_bytes"],
            plan_by_type=plan, checks=checks))
        if not all(checks.values()):
            bad[f"rank {r}"] = checks
    same = all((p["loss"], p["grad_norm"], p["dropped"])
               == (per[0]["loss"], per[0]["grad_norm"], per[0]["dropped"]) for p in per)
    if not same:
        bad["ranks"] = "the processes report different losses, grad norms or drops"
    emit(phase=17, card=smi, arch=c["arch"], layers=c["layers"], mesh=c["mesh"],
         procs=MESH_PROCS, batch=c["batch"], seq=c["seq"], dtype=want["dtype"],
         steps=want["steps"], params=model.cfg.param_count(), cut=MOE_TP_CUT,
         tolerance=dict(params_step1=f"{TP_PARAM_TOL} under AdamWConfig(eps=1e-3)",
                        step1_loss_and_grad_norm_rel=TP_METRIC_TOL[want["dtype"]],
                        dropped="equal"),
         one_device={k: v for k, v in ref.items() if k != "kept"},
         compared={name: ("whole" if dim is None else f"dim {dim} at {idx}")
                   for name, (dim, idx) in ref["kept"].items()},
         per_process=per, ranks_agree=same, seconds_at=[lg["marks"] for lg in logs],
         started_after_s=[lg["started_at"] - wall for lg in logs],
         one_device_seconds=ref_s, spawn_seconds=spawn_s, seconds=time.perf_counter() - t0)
    check(not bad, f"17: the MoE tensor-parallel step's checks failed: {bad}")
    shutil.rmtree(work, ignore_errors=True)


def phase18_family_tensor_parallel(dev, smi) -> None:
    """rwkv6, zamba2 and encdec split along ``model`` at full width on the
    card (see the module docstring)."""
    import math
    import shutil

    import torch

    from repro_torch.launch.hlo_analysis import mesh_step_collectives
    from repro_torch.launch.mesh import Mesh, _process_grid
    from repro_torch.launch.sharded import tp_check_all, tp_model

    t0 = time.perf_counter()
    work = ROOT / "build" / "family_tp_phase"
    shutil.rmtree(work, ignore_errors=True)
    threads = max(1, (os.cpu_count() or 2) // MESH_PROCS)
    cells = tp_check_all([dict(c, opt=TRAIN_EPS_RULE, device=dev.type, threads=threads)
                          for c in FAMILY_TP_FULL], work, MESH_PROCS, TP_SPAWN_TIMEOUT)
    out, bad = [], {}
    for cell in cells:
        c = cell["params"]
        procs = _process_grid(c["mesh"], MESH_PROCS)
        dims = (c["batch"], c["seq"]) + ((c["frames"],) if "frames" in c else ())
        runs = []
        for j, ref in enumerate(cell["references"]):
            dtype = c["runs"][j]["dtype"]
            model = tp_model(c, dtype)
            tol, loss_tol, norm_tol = FAMILY_TP_TOL[c["arch"], dtype]
            name = f"{c['arch']} {dtype}"
            per = []
            for r, lg in enumerate(cell["logs"]):
                got = lg["runs"][j]
                coords = tuple(int(x) for x in divmod(r, procs[1]))
                plan = mesh_step_collectives(model, Mesh(c["mesh"], ("data", "model"),
                                                         torch.device("cpu"), procs, coords,
                                                         {}), batch=dims).stats().by_type
                rel = {k: abs(got[k][0] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
                checks = dict(step1_loss=rel["loss"] <= loss_tol,
                              step1_grad_norm=rel["grad_norm"] <= norm_tol,
                              plan=all(b == plan for b in got["collective_bytes"]),
                              finite=all(math.isfinite(v)
                                         for v in got["loss"] + got["grad_norm"]))
                if tol is not None:
                    checks["params_step1"] = got["max_param_err"] <= tol
                peak = got["peak_memory_allocated"]
                per.append(dict(
                    rank=r, peak_memory_allocated=peak,
                    peak_ratio=peak / ref["peak_memory_allocated"] if peak else None,
                    param_bytes=got["param_bytes"], max_param_err=got["max_param_err"],
                    ms_per_step=[x * 1e3 for x in got["seconds"]],
                    collective_ms=[{k.replace("_s", "_ms"): v * 1e3 for k, v in t.items()}
                                   for t in got["timing"]],
                    tokens_per_s=[c["batch"] * c["seq"] / x for x in got["seconds"]],
                    loss=got["loss"], grad_norm=got["grad_norm"], rel_err_step1=rel,
                    collective_bytes=got["collective_bytes"], plan_by_type=plan,
                    checks=checks))
                if not all(checks.values()):
                    bad[f"{name} rank {r}"] = checks
            same = all((p["loss"], p["grad_norm"]) == (per[0]["loss"], per[0]["grad_norm"])
                       for p in per)
            if not same:
                bad[f"{name} ranks"] = "the processes report different losses or grad norms"
            runs.append(dict(
                dtype=dtype, params=model.cfg.param_count(),
                tolerance=dict(params_step1=(f"{tol} under AdamWConfig(eps=1e-3)"
                                             if tol is not None else "held in float64"),
                               step1_loss_rel=loss_tol, step1_grad_norm_rel=norm_tol),
                one_device={k: v for k, v in ref.items() if k != "kept"},
                per_process=per, ranks_agree=same))
        out.append(dict(arch=c["arch"], cut=FAMILY_TP_CUTS[c["arch"]], runs=runs,
                        seconds_at=[lg["marks"] for lg in cell["logs"]],
                        started_after_s=[lg["started_at"] - cell["wall"]
                                         for lg in cell["logs"]]))
    emit(phase=18, card=smi, mesh=FAMILY_TP_FULL[0]["mesh"], procs=MESH_PROCS, cells=out,
         spawn_seconds=cells[0]["spawn_seconds"], seconds=time.perf_counter() - t0)
    check(not bad, f"18: the families' tensor-parallel step's checks failed: {bad}")
    shutil.rmtree(work, ignore_errors=True)


def phase19_serve_tensor_parallel(dev, smi) -> None:
    """The decoders' split prefill and decode at full width on the card
    (see the module docstring)."""
    import shutil
    import statistics

    import torch

    from repro_torch.launch.hlo_analysis import serve_step_collectives
    from repro_torch.launch.mesh import Mesh, _process_grid
    from repro_torch.launch.sharded import serve_check_all, tp_model

    t0 = time.perf_counter()
    work = ROOT / "build" / "serve_tp_phase"
    shutil.rmtree(work, ignore_errors=True)
    threads = max(1, (os.cpu_count() or 2) // MESH_PROCS)
    cells = serve_check_all([dict(c, device=dev.type, threads=threads) for c in SERVE_TP_FULL],
                            work, MESH_PROCS, TP_SPAWN_TIMEOUT)
    out, bad = [], {}
    for cell in cells:
        c = cell["params"]
        name = f"{c['arch']} {tuple(c['mesh'])}"
        model = tp_model(c, c["dtype"])
        procs = _process_grid(c["mesh"], MESH_PROCS)
        tol = SERVE_TP_TOL.get((c["arch"], tuple(c["mesh"])))
        rel = cell["rel"]
        checks = dict(next_equal=cell["next_equal"],
                      bitwise_one_process=cell["bitwise_one_process"],
                      within_bound=tol is not None and all(
                          rel[k] <= tol[0 if k.endswith("logits") else 1] for k in rel))
        per = []
        for r, lg in enumerate(cell["logs"]):
            mesh = Mesh(tuple(c["mesh"]), ("data", "model"), torch.device("cpu"), procs,
                        tuple(int(x) for x in divmod(r, procs[1])), {})
            plan = [serve_step_collectives(model, mesh, "prefill",
                                           batch=(c["batch"], c["prompt"])).stats().by_type]
            plan += [serve_step_collectives(model, mesh, "decode", batch=(
                c["batch"], c["cache"])).stats().by_type] * c["steps"]
            checks[f"plan_rank{r}"] = lg["collective_bytes"] == plan
            peak = lg["peak_memory_allocated"]
            per.append(dict(
                rank=r, prefill_ms=lg["seconds"][0] * 1e3, prefill_tp_ms=lg["tp_s"][0] * 1e3,
                decode_ms=[x * 1e3 for x in lg["seconds"][1:]],
                decode_tp_ms=[x * 1e3 for x in lg["tp_s"][1:]],
                decode_median_ms=statistics.median(lg["seconds"][1:]) * 1e3,
                decode_tp_median_ms=statistics.median(lg["tp_s"][1:]) * 1e3,
                decode_compute_median_ms=statistics.median(
                    a - b for a, b in zip(lg["seconds"][1:], lg["tp_s"][1:])) * 1e3,
                peak_memory_allocated=peak, param_bytes=lg["param_bytes"],
                peak_ratio=peak / cell["one_device"]["peak_memory_allocated"] if peak else None,
                collective_bytes_prefill=lg["collective_bytes"][0],
                collective_bytes_decode=lg["collective_bytes"][1]))
        if not all(checks.values()):
            bad[name] = dict(checks, rel=rel, bound=tol)
        one = cell["one_process"]
        out.append(dict(arch=c["arch"], mesh=c["mesh"], cut=SERVE_TP_CUTS[c["arch"]],
                        rel=rel, bound=tol, checks=checks, per_process=per,
                        one_device=cell["one_device"],
                        one_process_decode_median_ms=statistics.median(one["seconds"][1:]) * 1e3,
                        one_process_prefill_ms=one["seconds"][0] * 1e3))
    emit(phase=19, card=smi, procs=MESH_PROCS, batch=SERVE_TP["batch"],
         prompt=SERVE_TP["prompt"], cache=SERVE_TP["cache"], steps=SERVE_TP["steps"],
         dtype=SERVE_TP["dtype"], cells=out, spawn_seconds=cells[0]["spawn_seconds"],
         seconds=time.perf_counter() - t0)
    check(not bad, f"19: the split serve step's checks failed: {bad}")
    shutil.rmtree(work, ignore_errors=True)


def result_on_cpu(res):
    """A card result's tensors on the CPU."""
    from repro_torch.core import SearchResult

    return SearchResult(res.ids.cpu(), res.dist.cpu(), res.steps.cpu(), res.iters)


def main() -> int:
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    from repro_torch.launch.sharded import start_forkserver, stop_forkserver

    start_forkserver(TP_PRELOAD)

    phase_seconds = {}

    def run(phase: int, fn, *args):
        """``fn(*args)``, its seconds kept under ``phase``."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_seconds[phase] = time.perf_counter() - t0
        return out

    smi = run(0, phase0_card)
    dev = torch.device("cuda")
    run(1, phase1_build)
    rows = run(2, phase2_kernels, dev)
    main_path = run(3, phase3_main_path, dev)
    check50 = run(4, phase4_checks, dev, main_path)
    path_launches = run(5, phase5_planes, dev, main_path, check50)
    path_launches["f32"] = main_path["launches"]
    scan_rows, path_launches["bench"] = run(6, phase6_bench, dev, main_path)
    rows.update(scan_rows)
    update_launches = run(7, phase7_updates, dev, main_path, check50, smi)
    serve_launches = run(8, phase8_serve, dev, main_path, smi)
    shard_launches = run(9, phase9_sharded, dev, main_path, check50, smi)
    legacy_launches = run(10, phase10_legacy_bench, dev, main_path, smi)
    tower_launches = run(11, phase11_towers, dev, smi)
    family_launches = run(12, phase12_families, dev, smi)
    training_launches = run(13, phase13_training, dev, smi)
    mesh_launches = run(14, phase14_mesh, dev, smi)
    dryrun_launches = run(15, phase15_dryrun, dev, smi)
    run(16, phase16_tensor_parallel, dev, smi)
    run(17, phase17_moe_tensor_parallel, dev, smi)
    run(18, phase18_family_tensor_parallel, dev, smi)
    run(19, phase19_serve_tensor_parallel, dev, smi)
    stop_forkserver()

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        # each kernel's launches on its own path (phase 3 or phase 5)
        path = next(p for p in PATH_KERNELS if name in PATH_KERNELS[p])
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path_launches[path][name], **CHECKED[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            **{k: r[k] for k in EXTRA_KEYS if k in r},
            **({"launches_updates": update_launches[name]} if name in UPDATE_KERNELS else {}),
            **({"launches_serve": serve_launches[name]} if name in SERVE_KERNELS else {}),
            **({"launches_sharded": shard_launches[name]} if name in SHARD_KERNELS else {}),
            **({"launches_legacy_bench": legacy_launches[name]}
               if name in LEGACY_BENCH_KERNELS else {}),
            **({"launches_towers": tower_launches[name]} if name in TOWER_KERNELS else {}),
            **({"launches_families": family_launches[name]}
               if name in FAMILY_KERNELS else {}),
            **({"launches_training": training_launches[name]}
               if name in TRAIN_KERNELS else {}),
            **({"launches_mesh": mesh_launches[name]} if name in MESH_KERNELS else {}),
            **({"launches_dryrun": dryrun_launches[name]} if name in DRYRUN_KERNELS else {})))
    left = children_left()
    check(not left, f"processes this run started are still running: {left}")
    emit(seconds=time.perf_counter() - t_start, phase_seconds=phase_seconds, card=smi,
         children_left=len(left))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
