#!/usr/bin/env python3
"""Drive the PyTorch port (``nmf_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                     # from the root of a checkout
    python3 chip_smoke.py --phases card,kernels,modes,quant   # a subset
    python3 chip_smoke.py --phases card,modes,flagship        # after a K1/K2 edit
    python3 chip_smoke.py --phases card,accel                 # the accelerated solves
    python3 chip_smoke.py --phases card,families,transform    # the families, the H-only path
    python3 chip_smoke.py --phases card,models                # separate, semi, masked, online
    python3 chip_smoke.py --phases card,selection             # batched solves, restarts, sweeps
    python3 chip_smoke.py --phases card,utils                 # I/O, checkpoints, live, doctor
    python3 chip_smoke.py --phases card,sparse                # the COO solve
    python3 chip_smoke.py --phases card,mesh                  # the mesh, sharded solves
    python3 chip_smoke.py --phases card,serving               # serving artifacts, export/serve
    python3 chip_smoke.py --phases card,examples              # nmf_tpu_torch.examples
    python3 chip_smoke.py --phases card,backend --backend-out backend_s1.json
                                                              # one session of the backend rule

Twenty phases, in order; any failure raises and the exit code is non-zero.
Every check that holds the kernels passes ``backend="pallas"``: under
``"auto"`` a solve takes the card's backend rule (``utils/autotune.py``),
which sends some shapes to cuBLAS.  The default path is held to that rule
in phase 6 (the reference pipeline's launches follow the rule's choice) and
phase 17.

1. card: assert CUDA, read the card's name and power limit, build the
   kernels from ``nmf_tpu_torch/csrc/`` (build seconds printed), print
   ptxas's registers and spills per kernel (a spill in any K1/K2, K3 or K5
   pass-1 kernel fails) and each pass-1 instance's registers, dynamic
   shared memory, blocks an SM and local memory as the runtime reports
   them (K3's 15 instances too; local memory fails), and check with
   ``cuobjdump -sass`` of the same toolkit that every BF16- and
   SPLIT3-Mode K1/K2 and K5 kernel and every BF16 K3 kernel holds
   tensor-core (``HMMA``) instructions and no F32- or ANY-Mode one does;
2. kernels: K1-K3 in float32 against their plain torch versions on the card
   at the reference, ISMIR and paper shapes (factors rtol 1e-4 / atol 1e-6,
   cost rel 1e-5), bitwise-equal on a second call, each timed beside its
   plain version with CUDA events (median of 10 samples of 10 back-to-back
   calls, in turns plain, kernel, kernel, plain), the pass-1 instance of
   K1/K2 read at the reference shape as in phase 3; then checked only at
   K = 8, 64, 300 and 2048 (every K chunk width, several chunks) and at
   65x129x17 and 127x350x255 (no row of W, H or X on 16 bytes: the SIMT
   pass 1's 4-byte copies), K3 also where its walk has edges
   (``KL_SHAPES``: M < 64, N < 64, N = 1, runs of two tiles split 157
   ways), each K3 call's instance read from the library's launches per Mode
   (``nmf_kl_launches``: F32 here), and K > 2048 shown to take the plain
   ops by the rank rule;
3. modes: each precision mode of K1-K3 (``bfloat16``, ``float32_fast``,
   bf16 X, int8 X, ``BF16_FULL`` with bf16 state, and ``float32_fast`` with
   bf16 X and with bf16 state and int8 X) against its plain
   version on the card at the reference shape (timed as in phase 2) and at
   K = 8, 64, 300 and 2048, bitwise-equal on a rerun, within ``MODE_LIMITS``.
   Where a mode rounds or splits the GEMM operands (``bfloat16``,
   ``float32_fast``, bf16 state; not ``float32_fast`` on bf16 state, which
   splits exactly), the same kernel without the rounding (f32 GEMMs) is
   run as a control on the same operands and must fail the
   limits, so a kernel that skipped it could not pass; the W and H of
   ``bfloat16`` and ``float32_fast`` are built so that skipping it biases
   every sum one way.  At the reference shape the library's count of
   pass-1 launches per Mode (``nmf_partial_launches``) over one K1 and one
   K2 call names the instance that ran: the tensor-core ones (``mma.sync
   bf16`` under ``bfloat16``, ``mma.sync split3`` under ``float32_fast``),
   ``simt`` else; K3 in every mode also at ``KL_SHAPES`` and phase 2's
   rows off 16 bytes, each call's instance read from ``nmf_kl_launches``
   (``kl_mode_expected``: BF16 under ``bfloat16``, F32 on f32 operands
   under both f32 policies, ANY for bf16 X, int8 X or bf16 state there);
4. quant: the quantizer on the card gives the codes and scales of
   ``quantize_columns_np`` byte for byte on the reference X, and those of
   ``quantize_rowblocks_np`` on a row-block case;
5. cli: the reference pipeline through the CLI, as subprocesses (every
   ``run`` below at once, then each checked): ``gen``,
   then ``run X.bin W.bin H.bin -o ... --jsonl`` at float32 and at each
   tier (``--dtype bfloat16``, ``--dtype float32_fast``, ``--x-dtype
   bfloat16``, ``--x-dtype int8``) and once at ``--x-dtype int8
   --x-quant-rows 32``: 200 iterations, 8 strictly decreasing checks;
   float32 and float32_fast within 1e-4 of the 96689.73 pin; then ``run
   X.bin --rank 128`` at the default init (nndsvda) and ``run ...
   --accelerate``, each byte-equal to the in-process solve (from
   ``nndsvd_init(X, 128, "nndsvda")``), and ``run ... --strict-compat``
   twice: de-padded to 4096 x 128 and 128 x 350, byte-equal on the rerun;
6. inprocess: the same runs in-process through ``solve``, each with the
   counts set to 0 just before it: exactly 200/200/8 launches of K1/K2/K3
   and 0 plain calls (0 launches for ``--x-quant-rows 32``, which takes the
   plain ops by rule); factors byte-identical on a rerun and to the CLI's
   files; the final cost against the ``backend="jnp"`` solve within 1e-4
   relative (1e-3 for ``bfloat16``, whose kernel cost has a bf16 recon);
7. flagship: 10240 x 10240, K=256: one call of K1 and K2 under
   ``float32``, ``bfloat16`` and ``float32_fast`` timed beside its plain
   version, its instance traced as in phase 3; then 50 iterations, float32,
   bfloat16 and float32_fast, through the kernels and through plain torch
   ops: final costs agree to 1e-4 (float32, float32_fast) and 1e-3
   (bfloat16); iterations/s and TFLOP/s for each, and exactly 50/50/2
   launches of K1/K2/K3 in each solve through the kernels; K3 timed once
   per policy beside ``kl_cost_plain``; then K1/K2 per call where
   a block's contraction walks farthest (``LONG_WALKS``: the flagship, and
   an hour of audio in memory, wide and tall, 303 tiles a split):
   ``bfloat16`` with f32 state (the update) and bf16 state (the f32
   numerator), and ``float32_fast`` with f32 state (the update), each
   within its ``MODE_LIMITS`` of its plain version with the f32-GEMM
   control failing; and K3 at the same shapes under ``float32``,
   ``bfloat16`` (the f32-recon control failing) and ``float32_fast``,
   within cost rel 1e-5;
8. tilesparse: K5 (``h_numerator`` / ``w_numerator``) against its plain
   version on the card at the ``tests/test_pallas.py`` problem (and the
   same with its tile list padded to 64 by zero tiles at block (0, 0), as
   the tiled solve pads it), 160 x 200 with 32^2 tiles, 288 x 480 with
   96 x 160 tiles, 8192^2 K=128 with 128^2 tiles at occupancy 0.08, K = 300
   and 2048, and two long runs (300 full 128^2 tiles down one column
   block, and across one row block), in every mode (float32, ``bfloat16``,
   ``float32_fast``, bf16 tiles, bf16 state) within ``MODE_LIMITS``, with
   phase 3's controls where a mode rounds or splits, bitwise on a rerun,
   sentinel blocks exactly zero, the pass-1 instance each call ran read
   from the library's launches per Mode (``nmf_sweep_launches``: BF16
   under ``bfloat16`` and bf16 state, SPLIT3 under ``float32_fast``, F32
   under float32, ANY for bf16 tiles), each mode timed at 8192^2; then the
   tile-sparse solve at 8192^2, K=128, 200 iterations under float32,
   bfloat16 and float32_fast: exactly 200 + 200 K5 launches, all in the
   policy's instance, byte-identical factors on a rerun, the cost against
   the ``backend="jnp"`` tiled solve and (float32) the dense
   ``clamp_inputs=False`` solve through K1-K3, iterations/s of all three;
   once at K=256 ``bfloat16``, and once with int8 tiles (the plain sweep by
   rule, 0 launches);
9. oocore: K1/K2 ``numerator_only`` in every mode against the plain
   numerators at phase 3's shapes, the streamed block 1025 x 65408 x 32
   (timed and its instance traced there) and the ragged last block
   1025 x 30592 x 32, within
   ``MODE_LIMITS`` with phase 3's controls (bf16 state: X built so that a
   skipped Z rounding shows), bitwise on a rerun, the full update equal bit
   for bit to ``base * numerator / denom`` and within the mode's limits of
   its plain version, and K > 2048 on the plain ops by rule; the streamed
   cost pass's K3 (f32 GEMMs; f32, bf16 and int8 X, bf16 state) against
   ``kl_cost_plain`` at the same shapes (rel 1e-5, timed at the block, its
   instance read there);
   then ``solve_out_of_core`` at an hour
   of audio, 1025 x 619264, K=32 (X made on the card from ``--seed``, moved
   to the host), 10 iterations, a cost pass every 5, in f32, bf16 and int8
   X: exactly blocks x iterations launches of K1 and of K2
   ``numerator_only``, blocks x passes of K3, the cost within 1e-5 of the
   in-memory ``solve`` (f32: and of the ``jnp`` streamed solve), factors
   within ``OOC_FACTOR_RTOL`` of it, byte-identical reruns, peak device
   memory under a third of X, the H2D rate, the fraction of the H2D
   roofline reached, the host's block fills (gather into pinned memory)
   and waits on the host clock, and the device's kernel / copy / overlap /
   idle shares (``torch.profiler``); and ``run --out-of-core --block-n 1024`` at 2048 x
   8192, K=128, through the CLI, its files byte-equal to the in-process
   streamed solve, its cost within 1e-5 of the in-memory solve;
10. accel: ``accelerate=True``, each solve with the counts set to 0 just
   before it.  (a) The reference pipeline (seed-0 fixtures, 200 iterations,
   f32 through K1-K3): K1/K2 launched ``iterations + 25 x rejects`` times,
   K3 ``1 (seed) + 8 + rejects``, 0 plain calls, the rejects read from the
   counts; the history non-increasing, the final cost at most the plain
   kernel solve's and within 1e-4 of the ``backend="jnp"`` accelerated
   solve, with its rejects (counted on its step and cost calls) and its
   momentum bit for bit; a bitwise rerun; the reject path forced by
   ``initial_cost=0`` (no seed cost, one block redone); it/s of the
   accelerated, accelerated ``jnp`` and plain kernel solves in turns; the
   extrapolation's time on W and H (CUDA events) and the device busy share
   of an accelerated and a plain solve (``torch.profiler``).  (b) The
   flagship, 50 iterations, ``bfloat16`` and ``float32``: launches, the
   cost against the ``jnp`` accelerated solve (1e-3 / 1e-4), it/s.  (c) The
   tile-sparse solve at 8192^2, K=128, 200 iterations, f32 and ``bfloat16``:
   K5 launched ``iterations + 25 x rejects`` times a sweep, a bitwise
   rerun, the cost against the ``jnp`` tiled accelerated solve.  (d) The
   streamed solve at the hour of audio, 10 iterations, a check every 5, f32
   and int8 X: blocks x (iterations + 5 x rejects) launches of K1 and K2
   ``numerator_only``, blocks x (1 + checks + rejects) of K3, the cost
   within 1e-5 of the in-memory accelerated solve, a bitwise rerun, it/s;
11. families: the beta (2, 0, 0.5, 3), HALS and penalized KL (``l1_h =
   l2_w = 0.1``) solves, and ``accelerate=True`` for beta 2 and HALS, at
   the reference fixtures, 200 iterations (HALS 100: launch-bound), f32,
   on the card: plain torch
   ops by rule, so 0 launches of K1-K3 and K5 (the counts set to 0 just
   before each); the final cost within ``FAMILY_COST_RTOL`` of the same
   solve on the CPU; a history that does not rise for beta >= 1, HALS and
   the accelerated solves; a bitwise rerun; it/s; one HALS sweep of H and
   of W timed (CUDA events) and the kernels one HALS iteration launches
   (torch.profiler);
12. transform: the H-only path at the ISMIR shape 1025 x 4000, K=32 (X
   from ``--seed`` on the card, W from a 200-iteration solve).  (a)
   ``solve_h_only``, 200 iterations, under float32, ``bfloat16``,
   ``float32_fast``, bf16 X and int8 X: exactly 200 K1, 0 K2 and 8 K3
   launches and 0 plain calls, every K3 launch in its F32 instance (ANY
   for bf16 or int8 X, read from ``nmf_kl_launches``), never BF16: the
   H-only cost has a true-f32 recon in every policy; the cost within 1e-4
   of the ``backend="jnp"`` H-only solve (1e-3 under ``bfloat16``), a
   bitwise rerun, it/s; and ``solve_w_only``: 200 K1 launches on the
   transposed problem, against ``jnp``.  (b) ``transform_out_of_core`` at
   the hour of audio (phase 9's 1025 x 619,264, K=32, 10 blocks), 50
   iterations a block, f32 and int8 X: blocks x 50 K1 and blocks x 2 K3
   launches, the block costs summed within 1e-5 of the in-memory
   ``solve_h_only`` from the same explicit H0 and H within
   ``OOC_FACTOR_RTOL`` of it, peak device memory under a third of X, the
   H2D rate and it/s.  (c) ``NMF(n_components=32, init="nndsvda").fit``
   (200/200/8 launches), ``transform`` of 1000 new columns (200/0/8), then
   ``normalize_factors``: W H moved by at most 1e-6 relative.  (d) The CLI
   as subprocesses: ``transform X W -o H``, in memory and ``--out-of-core
   --block-n 1024``, and ``run`` at the reference fixtures with ``--beta
   2``, ``--algorithm hals --beta 2`` and ``--l1-h 0.1``, each file
   byte-equal to the in-process result;
13. models: the models of ROADMAP.md Queue 1 step 6, each run with every
   count set to 0 just before it.  (a) ``separate`` at the paper's workload:
   20 s of audio at 44.1 kHz made from ``--seed`` (tones and noise bursts),
   ``n_fft`` 1024, hop 256 (X 513 x 3446), K=32, 200 iterations at thresh
   0: exactly 200/200/8 launches of K1/K2/K3, no plain call; the sources
   summed within 1e-4 of the peak of the mixture on the samples whose
   frames the Wiener masks cover; the cost within 1e-4 of the ``jnp`` solve
   of the same spectrogram; a bitwise rerun; the host seconds of the STFT,
   the solve and the masks with their ISTFTs.  (b) ``separate(w_template=)``
   with 8 templates learned from a 5 s clip of ``--seed + 1``: 200/200/8,
   the 8 columns bit-equal to the clamped templates, and
   ``adapt_template=True`` moving them.  (c) ``solve_semi`` at the ISMIR
   shape 1025 x 4000, K=32 (X from ``--seed``): ``n_frozen=0`` bitwise the
   kernel ``solve``, ``n_frozen=32`` H bitwise ``solve_h_only``;
   ``n_frozen=8`` under float32, ``bfloat16``, ``float32_fast``, bf16 X and
   int8 X: 200/200/8 launches, K1/K2 in their policy's instance
   (``nmf_partial_launches``) and K3 in its Mode, the frozen columns
   bit-equal, the cost within 1e-4 of the ``jnp`` semi solve (1e-3 under
   ``bfloat16``); ``accelerate=True`` keeping the columns bit-equal.  (d)
   ``solve_masked`` and ``solve_masked_h_only`` at the reference fixtures
   with 20% of X missing (NaN): no K1-K3 or K5 launch, the cost within 1e-5
   of the same solve on the CPU, a bitwise rerun, it/s; a mask of ones
   within 1e-5 of the ``jnp`` solve.  (e) ``solve_out_of_core`` at the hour
   of audio (phase 9's shape, 10 blocks), 5 iterations and one cost pass,
   f32 X: beta 2, HALS, penalized KL (``l1_h = l2_w = 0.1``), masked (10%
   missing) and ``n_frozen=8``, each within 1e-5 of the in-memory solve of
   the same family; ``n_frozen=8`` launching blocks x 5 K1 and K2
   ``numerator_only`` and blocks x 1 K3, the plain families nothing; the
   H2D roofline share (the mask's bytes counted), block fills, and peak
   device memory under a third of X (and the mask).  (f) ``solve_online``
   at the hour of audio, one pass, 20 inner iterations, blocks of 65,408:
   no launch, the learning curve per column falling from the first block
   to the last, a bitwise rerun, blocks/s and the host-fill share; at
   1025 x 4000, blocks of 500, W within 1e-5 (relative Frobenius norm) of
   the CPU run.  (g) The CLI, nine subprocesses at once: ``run --mask`` in
   memory and ``--out-of-core --block-n 1024``, ``run --freeze 8`` in
   memory and streamed, ``run --out-of-core --beta 2`` and ``--algorithm
   hals --beta 2``, ``run --online``, ``transform --mask`` and ``separate``
   of (a)'s audio written as a WAV: each file byte-equal to its in-process
   result;
14. selection: the batched solves of ROADMAP.md Queue 1 step 7, each run
   with every count set to 0 just before it.  (a) Config 4: 128 x 513 x
   2000, K=32 (``benchmarks/run_all.py:569``), X made on the card from
   ``--seed``: K1-K3 over the member axis once each against the plain
   batched version (cuBLAS batched GEMMs; rel 1e-4, cost 1e-5), timed as
   phase 2 times (5 samples of 5), members 0, 63 and 127 bit-equal to the
   2-D call, the partials' bytes; then ``solve_batched``, 100 iterations,
   ``track_cost=False``, under ``float32`` and ``bfloat16``, through the
   kernels and through ``backend="jnp"``: problem-iterations/s and TFLOP/s
   of each, 100/100/0 launches serving 12,800 member-calls each, members
   0, 63 and 127 bit-equal to their 2-D ``solve``, peak device memory.
   (b) ``solve_restarts`` R=16 at 512 x 1024, K=32, 100 iterations against
   16 sequential ``solve``s: every member bit-equal, ``best_index`` the
   argmin, and with ``n_frozen=8`` the frozen columns bit-equal.  (c)
   ``solve_rank_sweep([8, 16, 24, 32] x 2)``: the embedded slots exact
   zeros, each cost within 1e-5 of the single rank-k solve.  (d)
   ``rank_stability`` ranks 4, 8, 12, 16 x 8 restarts: the solve's and the
   host consensus's seconds apart.  (e) The plain paths, no launch:
   ``solve_batched(mask=)`` 16 x 513 x 2000 with 20% missing, each cost
   within 1e-5 of the member's ``solve_masked``; ``solve_sparse_tiled_batched``
   of 4 members of phase 8's layout cut to 4096^2, K=128, each within
   1e-5 of its ``solve_sparse_tiled``; and a ``thresh=1e-4`` batch of 8
   whose members stop at different iterations, each its own solve's count
   and bits.  (f) The CLI, four subprocesses at once: ``batch`` on 16
   files, ``select --ranks 8,16,24,32 --stability -o``, ``run --restarts
   8 -o`` and ``separate --restarts 4``, each file byte-equal to the same
   call in-process;
15. utils: ``native/binio.cpp`` built with the host compiler into
   ``build/nmf_tpu_torch/native/`` (``NMF_TPU_NATIVE_LIB`` pointed there;
   ``native/`` is never written), then (a) ``BinDataset`` over 128 files
   of 513 x 2000 (config 4's input, 525 MB) with the native reader and
   with NumPy's (``NMF_TPU_NO_NATIVE=1``), in turns, bit-equal, seconds of
   each; (b) ``solve_out_of_core`` from a 1025 x 65408 ``.bin`` (K=32, 5
   iterations and a cost pass) with native and with NumPy reads, at 16352
   columns a block and at 16384 (rows a power of two apart in the native
   transpose): the factors bit-equal, native column reads above 0 (none
   on NumPy's), the host fill seconds of each; (c) ``solve_with_checkpoints`` on the reference
   pipeline (200 iterations, every 50): 200/200/8 K1/K2/K3 launches, the
   straight ``solve``'s bits, and a run stopped after two segments and
   resumed bit-equal to the uninterrupted one, also under
   ``accelerate=True`` (momentum and carry too); (d) the streamed solve
   at (b)'s shape checkpointed every 5 of 10 iterations, blocks x 10 /
   blocks x 10 / blocks x 2 launches, stopped at 5 and resumed bit-equal;
   (e) the checkpointed tile-sparse solve at 8192^2, K=128: 200 + 200 K5
   launches, the straight tiled solve's bits, resumed bit-equal; (f)
   ``live_metrics`` on the reference solve: 200/200/8 launches, the
   factors bit-equal to live off, the 8 emissions the history, it/s on and
   off in turns; (g) ``stage_timings`` at the reference shape (ms) and a
   ``trace`` whose kernels name K1 and K2; (h) ``python -m nmf_tpu_torch
   doctor --json`` as a subprocess: exit 0, ``up``, the card's name;
16. sparse: the deprecated COO ``solve_sparse`` (plain torch ops: no TPU
   kernel exists for it) at phase 8's layout, 8192^2, K=128, 128^2 tiles at
   occupancy 0.08, seed 0 (~5.2M nonzeros), 20 iterations, a check every 5:
   no K1-K3 or K5 launch, bitwise on a rerun (the nonzeros sorted once on
   the host, summed per index in a fixed order: no atomics), cost and
   factors (relative Frobenius norm) within 1e-5 of the dense
   ``clamp_inputs=False`` solve; its it/s beside the tile-sparse solve's
   and the dense solve's, and its peak device memory beside dense X's
   bytes;
17. backend: the H100 backend rule.  (a) Each shape of ``BACKEND_SHAPES``
   (paper, ismir, reference and flagship under ``float32``,
   ``float32_fast`` and ``bfloat16``; bf16 and int8 X at the reference
   shape and the flagship; the streamed block; config 4 batched in f32 and
   ``bfloat16``) measured as ``pick_backend`` measures it
   (``autotune._measure``: a loop of 10 steps through the kernels and
   through the plain ops between CUDA events, 5 samples each in turns),
   and K5 against the plain sweep at 8192^2 (phase 8's layout), K = 128,
   256 and 384, each policy: both medians, the faster, the rule's choice
   and whether they agree (a disagreement is printed, not failed: one
   session is noise; ``--backend-out`` writes the samples, and
   ``backend_rule.py`` pools three sessions).  (b) An ``auto`` solve at each
   shape through ``solve`` (and at the f32 shapes ``solve_semi`` and
   ``solve_h_only``), the streamed solve (a full block of 65408 columns and
   a ragged one), ``solve_batched`` at config 4 and ``solve_sparse_tiled``
   at 8192^2: the K1/K2 (K5) launches of the rule's choice, iterations or
   0, and the choice counted in ``autotune.CHOICES``.  (c)
   ``backend="autotune"`` twice at the ISMIR shape with a fresh cache file:
   the first solve measures once and writes a key naming the card, the
   second measures nothing.  (d) ``doctor --json``'s ``chip_spec``: the
   card's name and both peaks of its row (989 / 67 TFLOP/s on the H100);
18. mesh: the sharded solves of ROADMAP.md Queue 1 step 12a, each run with
   every count set to 0 just before it.  (a) An in-process 1x1 mesh over a
   one-rank NCCL group, the reference pipeline (200 iterations, 8 checks)
   with ``backend="pallas"``: exactly 200/200 K1/K2 ``numerator_only``
   launches and no full K1/K2, K3 or K5 launch (the mesh cost is plain, as
   JAX's); the cost within 1e-4 of the pin; a bitwise rerun; the cost
   within 1e-5 and W, H within 1e-4 (relative Frobenius) of the
   single-device card ``solve``; it/s of both in turns; four NCCL
   all-reduces of a step's sizes on the one rank timed (the 1x1 mesh skips
   them); kernels a step and the device's busy share of both solves
   (``torch.profiler``).  (b) The flagship 10240^2, K=256, 50 iterations on the 1x1 mesh
   under ``auto``, ``float32`` and ``bfloat16``: the route
   ``rule_pick`` gives the local shape (counted in ``autotune.CHOICES``
   under ``sharded``) and its launches (50/50 ``numerator_only`` or none),
   the cost within 1e-5 of the single-device solve's, it/s of both.
   (c) Four ranks spawned on the one card (``chip_smoke.py --mesh-rank``)
   over gloo, a 2x2 mesh (local 2048 x 175), the reference with ``backend="pallas"``: every rank 200/200
   ``numerator_only`` and no other launch, twice, the rerun's gathered bits
   equal; the gathered W, H and the cost held at (a)'s limits against the
   single-device solve and against the same 2x2 mesh on the plain route
   (``backend="jnp"``, no launch); int8 X under ``auto``: no launch (the
   plain route), the cost within 1e-5 of the single-device plain int8
   solve.  (d) ``python -m torch.distributed.run --standalone
   --nproc-per-node 1 -m nmf_tpu_torch run ... --mesh 1x1``: the cost
   within 1e-4 of the pin, ``Wm.bin`` byte-equal to (a)'s W.  (e) K1/K2
   ``numerator_only`` against ``mu.numerator_h``/``numerator_w`` at the
   shapes the mesh gives them, as phase 9a holds them (its limits, and its
   control where the mode has one): a 2048 x 175 x 128 block in every mode
   of phase 9a, the reference fixture's four blocks of (c), and (b)'s
   bfloat16 flagship on phase 7's exposed operands and on (b)'s own.
19. serving: the artifacts of ROADMAP.md Queue 1 step 13, each served call
   with every count set to 0 just before it.  (a) ``bench.py``'s serving
   rows, 2048 x 16384, K=128, blocks of 2048, 50 iterations, a check at
   50, X and W from ``--seed``: an ``auto`` and a ``jnp`` artifact on the
   f32 wire, an int8 quantized-input one and an in-program int8 one.
   ``auto`` resolves once at load (``autotune.CHOICES`` under ``serve``)
   to the kernels: a served call launches K1 8 x 50 = 400 times and K3 8
   times, the ``jnp`` artifact nothing; every block bit-equal to
   ``solve_h_only`` on it at the resolved backend; ``auto`` against
   ``jnp``: cost rel 1e-5, H relative Frobenius 1e-4; quantized-input
   bit-equal to in-program int8, ``prefetch=False`` to the pipelined
   call; cols/s (median of 3 after a warm call) on each wire, the share of
   the pinned H2D roofline (wire bytes as ``bench.py:345-349`` counts them,
   over a pinned copy's rate of the same run), the host's seconds a call
   by part, the device's busy share (torch.profiler), and K1/K3 at the
   block beside their plain versions.  (b) The ISMIR shape 1025 x 4000,
   K=32, blocks of 1024 (the last padded), 20% missing as NaN: the masked
   f32 and v4 masked x quantized artifacts (plain ops, no launch), v4
   bit-equal to the masked in-program int8 artifact, block 0 bit-equal to
   ``solve_masked_h_only``, ``stream_bin`` with and without ``out_path``
   byte-equal to the call.  (c) The CLI at the reference fixtures, blocks
   of 128: ``export`` plain, ``--quantized-input``, ``--masked`` and
   ``--mesh 1x1``; ``serve`` as a subprocess, ``--out-of-core``,
   ``--no-prefetch``, the quantized and the masked serves and ``info`` in
   process, each file byte-equal to the in-process call; a JAX-format zip
   refused by ``serve`` (exit 2) and carried across by
   ``utils.convert.serving_from_jax``.  (d) Mesh artifacts at the
   reference shape, 50 iterations, plain ops: a 1x1 NCCL artifact in
   process and a 2x2 one on four gloo ranks sharing the card
   (``chip_smoke.py --serve-rank``), each within cost rel 1e-5 and H 1e-4
   (relative Frobenius) of the single-device ``jnp`` artifact, every
   rank's counts 0; ``serve --mesh 1x1`` under ``torch.distributed.run``
   byte-equal to the in-process call.
20. examples: the five of ``nmf_tpu_torch.examples`` (ROADMAP.md Queue 1
   step 14), each through its ``main`` with a ``section`` hook that sets
   every count to 0 just before each section and reads it just after.  (a)
   Each at full size on the card: no figure NaN; each section's K1-K3 and
   K5 launches those of its route (``EX_ROUTES``; the choice read from
   ``autotune.CHOICES``): its iterations and checks where the rule keeps
   the kernels (K5 30 + 30 in the tile-sparse section, K1/K2
   ``numerator_only`` on the 1x1 mesh, the accelerated sections' rejects
   read from the counts), 0 in the restarts, sweep and stability sections
   (batched cuBLAS by the rule) and in the plain ones; the precision
   sections' K1/K2 and K3 Modes (``EX_MODES``); ``basic_usage``'s files
   round-tripping, ``stream_bin`` bitwise, the frozen columns intact, the
   out-of-core cost within 1e-5 of the in-memory one; wall and section
   seconds.  (b) Each quick (``NMF_TPU_EXAMPLE_QUICK=1``) on the card and
   on the CPU in this process, every returned figure held at the
   tolerances of ``tests/test_torch_examples.py``.  (c) ``distributed``:
   (a)'s in-process 1x1 NCCL run and a 2x2 gloo group of four ranks on the
   card under ``torch.distributed.run`` (``chip_smoke.py --example-rank``),
   every rank exiting 0 with its launches and its placement line, each
   run's costs within 1e-5 of the same work on one device.

Every number printed carries the card's name and power limit.  The line
before the last is the card as ``nvidia-smi`` names it, the one before that
a JSON summary of the kernels (each with its launches on its main path,
its time beside its plain version's, and its bound: the larger of its
flops over the card's peak and its bytes over 3.35 TB/s, H100 SXM at 700 W;
no single PyTorch call computes any of them, so ``library_ms`` is null;
each K1/K2 and K5 entry, mode and flagship entry names the instance that
ran, ``impl``, K1-K3 carry phase 7's ``long_walks`` readings, and K1-K3
and K5 phase 1's ``pass1`` (registers, shared memory, blocks an SM per
instance); K3 its instance in each mode and its launches on the
reference, streamed and flagship solves (``solve_launches``);
K1's and K2's ``numerator_only`` modes and K3's ``streamed`` modes carry
their launches on the streamed solve; every kernel its launches on phase
10's accelerated solves, ``accel_launches``; K1-K3 their launches on each
run of phase 12, ``transform_launches``, K2's all 0, and on each run of
phase 13, ``models_launches``, and of phase 14, ``selection_launches``,
with phase 14's config-4 call in ``batched``; every kernel its launches on
phase 15's runs, ``utils_launches``, and on phase 18's mesh solves,
``mesh_launches``: K1's and K2's ``numerator_only`` launches, K3's), and on
phase 19's served calls, ``serve_launches``, and on each section of
phase 20a's examples, ``examples_launches``; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
PIN_COST = 96689.73               # tests/test_parity.py:144
EPS = float(np.float32(2.2204e-16))
SHAPES = [(4096, 350, 128), (1025, 4000, 32), (513, 3445, 30)]   # (M, N, K)
# correctness only: K chunk widths 16 and 64, two chunks, the K=2048 ceiling;
# rows of W, H and X off 16 bytes (K and N odd) at chunk widths 32 and 256
COVERAGE_SHAPES = [(100, 70, 8), (333, 333, 64), (257, 129, 300), (300, 200, 2048),
                   (65, 129, 17), (127, 350, 255)]
# K chunk widths 128, 16, 64 (the tensor-core kernels' R = 4 stages apart),
# two chunks, the K=2048 ceiling
MODE_SHAPES = [(4096, 350, 128), (100, 70, 8), (333, 333, 64), (257, 129, 300),
               (300, 200, 2048)]
# phase 7: bfloat16 and float32_fast K1/K2 per call where a block's
# contraction walks farthest (the mma sums over a whole walk): the flagship
# (40 tiles a split) and an hour of audio in memory, wide (K2: 303) and
# tall (K1: 303)
LONG_WALKS = [(10240, 10240, 256), (1025, 619_264, 32), (619_264, 1025, 32)]
# K3 where its walk (K1's side: 64 columns, a run of M tiles) has edges:
# M < 64, N < 64, N = 1, and runs of two tiles split 157 ways (the last
# one tile); phase 3 also checks phase 2's rows off 16 bytes in every mode
KL_SHAPES = [(40, 333, 24), (700, 50, 40), (300, 1, 8), (20_000, 100, 16)]
KL_MODE_SHAPES = [(65, 129, 17), (127, 350, 255), *KL_SHAPES]
F32_TOL = (1e-4, 1e-6, 1e-5)          # phase 2: factors rtol, atol; cost rel
# Phase 3, per kind of mode, (max, spread, cost); None: not limited.  max:
# the largest relative error |kernel - plain| / |plain| of a factor.  spread:
# its RMS over the entries, or under bf16 state the share of entries that
# differ (each by one bf16 ulp at most, checked).  cost: relative error.
# Where a mode rounds or splits, a control (the kernel without it) must
# read above the spread and cost limits; each limit lies between the sound
# kernels' readings and the controls' on the card (PERF.md, PR 2).  The max
# allows bf16 flips: a last-ulp difference in W H may flip the rounding of a
# Z entry, moving a sum over N terms by 2**-8 of one term.
MODE_LIMITS = {
    "f32_gemm": (1e-4, None, 1e-5),     # bf16 X, int8 X: f32 GEMMs
    "bfloat16": (1e-3, 3e-5, 1e-5),
    "float32_fast": (1e-4, 2e-6, 1e-5),
    "bf16_state": (None, 1e-3, 1e-5),   # and one bf16 ulp at most
}
SAMPLES, CALLS = 10, 10
KERNELS = [
    # name, TPU kernel it replaces, source of the port's kernel
    ("update_h", "nmf_tpu/ops/pallas/fused_mu.py:245", "nmf_tpu_torch/csrc/fused_mu.cu"),
    ("update_w", "nmf_tpu/ops/pallas/fused_mu.py:378", "nmf_tpu_torch/csrc/fused_mu.cu"),
    ("kl_cost", "nmf_tpu/ops/pallas/fused_mu.py:516", "nmf_tpu_torch/csrc/fused_mu.cu"),
    ("h_numerator", "nmf_tpu/ops/pallas/tile_sparse.py:122", "nmf_tpu_torch/csrc/tile_sparse.cu"),
    ("w_numerator", "nmf_tpu/ops/pallas/tile_sparse.py:122", "nmf_tpu_torch/csrc/tile_sparse.cu"),
]
# Published peaks of one H100 SXM at 700 W (dense): f32 on the SIMT units,
# bf16 on the tensor cores, and the HBM rate.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
# Phase 8: the main tile-sparse problem (benchmarks/run_all.py:436-612,
# RETUNE_r05 cells tile_sparse_*): m, n, k, tile edge, occupancy, seed
TS_MAIN = (8192, 8192, 128, 128, 0.08, 0)
TS_ITERS = 200
# CLI tiers: name -> extra flags (the names of phase 3's modes where they match)
TIERS = {
    "float32": [],
    "bfloat16": ["--dtype", "bfloat16"],
    "float32_fast": ["--dtype", "float32_fast"],
    "x_bfloat16": ["--x-dtype", "bfloat16"],
    "x_int8": ["--x-dtype", "int8"],
    "x_int8_rows32": ["--x-dtype", "int8", "--x-quant-rows", "32"],
}
PHASES = ("card", "kernels", "modes", "quant", "cli", "inprocess", "flagship", "tilesparse",
          "oocore", "accel", "families", "transform", "models", "selection", "utils", "sparse",
          "backend", "mesh", "serving", "examples")
# csrc/mu_tile.cuh's Mode, in the order of its values; the pass-1 instance
# of K1/K2 that each runs on
MODES = ("F32", "ANY", "SPLIT3", "BF16")
IMPL = {"BF16": "mma.sync bf16", "SPLIT3": "mma.sync split3"}   # F32, ANY: "simt"
# the GEMM policy -> the K1/K2 instance it routes to
IMPL_OF_POLICY = {"bfloat16": IMPL["BF16"], "float32_fast": IMPL["SPLIT3"]}
# the Modes of K1/K2 on the tensor cores, each phase 1 holds to HMMA, and on
# the SIMT units, to none
MMA_MODES = tuple(IMPL)
SIMT_MODES = tuple(m for m in MODES if m not in IMPL)
_KERNEL_RE = re.compile(r"(h_update_partial|w_update_partial|h_sweep_partial|w_sweep_partial"
                        r"|kl_partial|kl_final|finalize|sum_splits|sweep_sum)"
                        r"(?:ILi(\d+)E)?(?:I?LNS\d*_4ModeE(\d)E)?")
# the pass-1 kernels, K1/K2's and K5's, by name
PASS1_KERNELS = (("h_update_partial", 1, "nmf_partial_info"), ("w_update_partial", 0, "nmf_partial_info"),
                 ("h_sweep_partial", 1, "nmf_sweep_info"), ("w_sweep_partial", 0, "nmf_sweep_info"))
# each kernel's pass-1 kernel, whose instances the result line lists
PASS1_OF = {"update_h": "h_update_partial", "update_w": "w_update_partial",
            "h_numerator": "h_sweep_partial", "w_numerator": "w_sweep_partial",
            "kl_cost": "kl_partial"}
PASS1_NAMES = {name for name, _, _ in PASS1_KERNELS}
# K3's Modes (no SPLIT3: its recon is true f32 under float32_fast)
KL_MODES = ("F32", "ANY", "BF16")
# phase 8's K5 modes -> the Mode of the pass-1 instance each runs
K5_MODE = {"float32": "F32", "bfloat16": "BF16", "float32_fast": "SPLIT3", "bf16_tiles": "ANY",
           "bf16_state": "BF16"}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def _auto_choice(cfg, m, k, n, members=1):
    """What ``cfg``'s backend resolves to for a solve of this shape on the
    card (``autotune.resolve_backend``, counted under ``"chip_smoke"``)."""
    from nmf_tpu_torch.utils import autotune

    return autotune.resolve_backend(cfg, m, k, n, "cuda", "chip_smoke", members)


def _launches(**counts):
    """Every K1-K3 launch count (``fused_mu.LAUNCHES``' keys), 0 unless given."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    return {key: counts.get(key, 0) for key in fused_mu.LAUNCHES}


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound(flops, nbytes, kind="float32"):
    """(least ms the card could take, "operations" or "bytes"): the larger
    of ``flops`` over the peak of ``kind`` and ``nbytes`` over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[kind], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def event_ms(fn, samples=SAMPLES, calls=CALLS) -> float:
    """Time of one call by CUDA events: the median over ``samples`` of
    ``calls`` back-to-back calls each (a lone call between two events
    measures mostly its launch), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def timed_pair(kern, plain, samples=SAMPLES, calls=CALLS):
    """(kernel ms, plain ms): plain, kernel, kernel, plain, in one call."""
    p1 = event_ms(plain, samples, calls)
    k1 = event_ms(kern, samples, calls)
    k2 = event_ms(kern, samples, calls)
    p2 = event_ms(plain, samples, calls)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _kernel_label(mangled):
    """``h_update_partial<R=16,BF16>`` for a mangled kernel name, or the
    name itself where it is none of the port's kernels."""
    m = _KERNEL_RE.search(mangled)
    if not m:
        return mangled
    args = ([f"R={m.group(2)}"] if m.group(2) else []) + ([MODES[int(m.group(3))]] if m.group(3) else [])
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def _check_sass(card, lib_path):
    """Every BF16- and SPLIT3-Mode pass-1 kernel of the built library (K1/K2
    and K5) holds HMMA (tensor-core) instructions and no F32- or ANY-Mode
    one does: ``cuobjdump -sass`` of the toolkit that built it (a missing
    cuobjdump fails the phase)."""
    from nmf_tpu_torch.ops.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    check(tool.is_file(), f"no cuobjdump beside {_build._nvcc()}: the SASS check cannot run")
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    hmma, label = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            label = _kernel_label(fn.group(1))
            hmma.setdefault(label, 0)
        elif label and "HMMA" in line:
            hmma[label] += 1
    partial = {n: c for n, c in hmma.items() if n.split("<")[0] in PASS1_NAMES}
    by_mode = {mode: {n: c for n, c in partial.items() if n.endswith(f",{mode}>")}
               for mode in MODES}
    for mode in MMA_MODES:
        check(len(by_mode[mode]) == 20 and all(by_mode[mode].values()),
              f"{mode}-Mode K1/K2/K5 kernels without HMMA (or missing): {by_mode[mode]}")
    for mode in SIMT_MODES:
        check(len(by_mode[mode]) == 20 and not any(by_mode[mode].values()),
              f"{mode}-Mode K1/K2/K5 kernels with HMMA (or missing): {by_mode[mode]}")
    kl = {n: c for n, c in hmma.items() if n.startswith("kl_partial<")}
    kl_by_mode = {mode: {n: c for n, c in kl.items() if n.endswith(f",{mode}>")} for mode in KL_MODES}
    check(len(kl) == 15 and all(len(v) == 5 for v in kl_by_mode.values()),
          f"K3 kernels missing: {kl}")
    check(all(kl_by_mode["BF16"].values()), f"BF16 K3 kernels without HMMA: {kl_by_mode['BF16']}")
    check(not any(c for mode in ("F32", "ANY") for c in kl_by_mode[mode].values()),
          f"F32/ANY K3 kernels with HMMA: {kl_by_mode}")
    for mode in MMA_MODES:
        print(f"[{card}] SASS ({tool}): HMMA instructions in each {mode}-Mode K1/K2/K5 "
              f"kernel {by_mode[mode]}")
    print(f"[{card}] SASS: no HMMA in the 40 F32- and ANY-Mode K1/K2/K5 kernels")
    print(f"[{card}] SASS: HMMA instructions in each BF16 K3 kernel {kl_by_mode['BF16']}, none in "
          "the 10 F32 and ANY ones")


def kl_counts(fn):
    """(fn(), K3's pass-1 launches per Mode, in MODES' order) as the library
    counts them on the host (``nmf_kl_launches``), set to 0 just before."""
    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    lib.nmf_reset_kl_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, [lib.nmf_kl_launches(i) for i in range(len(MODES))]


def kl_mode_expected(prec, w, x):
    """The Mode a K3 call must run: BF16 under ``bfloat16`` (any state and
    X), F32 on f32 W, H and X under both f32 policies, else ANY."""
    if prec.matmul_dtype == "bfloat16":
        return "BF16"
    dense_f32 = not isinstance(x, tuple) and x.dtype == torch.float32
    return "F32" if w.dtype == torch.float32 and dense_f32 else "ANY"


def kl_instance(mode, k):
    """K3's instance label at rank ``k``, as phase 1 lists it."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    return f"kl_partial<R={fused_mu.chunk_width(k) // 16},{mode}>"


def _kl_impl(instance):
    """``mma.sync bf16`` for a BF16 K3 instance, ``simt`` for F32 and ANY."""
    return IMPL["BF16"] if instance.endswith(",BF16>") else "simt"


def _check_kl_mode(kern, w, h, x, prec, where):
    """One more K3 call, counted: the Mode it ran must be the one
    ``kl_mode_expected`` names; returns its instance label."""
    _, counts = kl_counts(lambda: kern(w, h, x))
    ran = _mode_of_counts(counts, where)
    want = kl_mode_expected(prec, w, x)
    check(ran == want, f"{where}: K3 ran the {ran} instance, expected {want}")
    return kl_instance(ran, w.shape[1])


def _mode_of_counts(counts, what):
    """The one Mode with launches in ``counts`` (launches per Mode, in
    MODES' order)."""
    ran = [mode for mode, n in zip(MODES, counts) if n]
    check(len(ran) == 1, f"{what}: pass-1 launches per Mode {dict(zip(MODES, counts))}")
    return ran[0]


def _impl_of_counts(counts, what):
    """The pass-1 instance (``IMPL``'s, or "simt") of the one Mode with
    launches in ``counts``."""
    return IMPL.get(_mode_of_counts(counts, what), "simt")


def sweep_counts(fn):
    """(fn(), {"h_numerator": [launches per Mode], "w_numerator": [...]}):
    K5's pass-1 launches per Mode as the library counts them on the host,
    set to 0 just before ``fn``."""
    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    lib.nmf_reset_sweep_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, {key: [lib.nmf_sweep_launches(h, i) for i in range(len(MODES))]
                 for key, h in (("h_numerator", 1), ("w_numerator", 0))}


def observed_impls(fn):
    """{"update_h": impl, "update_w": impl} of the K1/K2 pass-1 kernels that
    ``fn`` launched: the library counts each pass-1 launch per Mode on the
    host as it makes it (``nmf_partial_launches``), set to 0 just before.
    (torch.profiler traces of the call lost pass-1 kernels on the H100,
    at the streamed block on every retry: PERF.md section 6.)"""
    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    lib.nmf_reset_partial_launches()
    fn()
    torch.cuda.synchronize()
    impls = {}
    for key, h in (("update_h", 1), ("update_w", 0)):
        counts = [lib.nmf_partial_launches(h, i) for i in range(len(MODES))]
        if any(counts):
            impls[key] = _impl_of_counts(counts, key)
    return impls


def _check_impls(fn, prec, where):
    """The K1/K2 instances ``fn`` ran, each the one its GEMM policy routes
    to: the tensor cores under ``bfloat16`` and ``float32_fast``, SIMT
    under ``float32``."""
    want = IMPL_OF_POLICY.get(prec.matmul_dtype, "simt")
    impls = observed_impls(fn)
    check(set(impls) == {"update_h", "update_w"} and set(impls.values()) == {want},
          f"{where}: K1/K2 ran {impls}, expected {want}")
    return impls


def phase_card(card, out):
    print(f"[{card}] phase 1: card and build")
    from nmf_tpu_torch.ops.kernels import _build

    lib_path = _build.library_path()
    fresh = not lib_path.exists()
    t0 = time.perf_counter()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[{card}] kernels {'built' if fresh else 'loaded (already built)'} "
          f"in {secs} s: {lib_path.relative_to(REPO)}")
    log = lib_path.parent / "build.log"
    if fresh and log.exists():
        # one line per kernel: registers and spills from ptxas -v
        name, spilled = None, []
        for line in log.read_text().splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                name = _kernel_label(entry.group(1))
            elif name and ("spill" in line and " 0 bytes spill stores" not in line or "Used" in line):
                print(f"[{card}]   {name}: {line.split('info    :')[-1].strip()}")
                if "spill" in line:
                    spilled.append(name)
        # the F32 and BF16 Modes of K1/K2 and K5 hold two blocks an SM only
        # without spills (PERF.md section 6); SPLIT3 holds one, with no spill
        # either
        bad = [n for n in spilled if n.split("<")[0] in PASS1_NAMES | {"kl_partial"}]
        check(not bad, f"K1/K2/K3/K5 pass-1 kernels spill: {bad}")
    _check_sass(card, lib_path)
    out["build_seconds"] = secs
    out["pass1"] = _pass1_info(card)


def _pass1_info(card):
    """{"h_update_partial<R=16,F32>": {"registers", "smem_bytes",
    "blocks_per_sm", "local_bytes"}, ...} of every K1/K2, K3 and K5 pass-1
    instance, as the runtime reports them (``nmf_partial_info``,
    ``nmf_kl_info``, ``nmf_sweep_info``); a kernel with local memory (a
    spill) fails."""
    import ctypes

    from nmf_tpu_torch.ops.kernels import _build

    lib = _build.load_library()
    info = {}
    for mode_i, mode in enumerate(MODES):
        for name, h, query in PASS1_KERNELS:
            for r in (1, 2, 4, 8, 16):
                vals = (ctypes.c_int * 4)()
                rc = getattr(lib, query)(h, mode_i, 16 * r, vals)
                check(rc == 0, f"{query} {name} R={r} {mode}: CUDA error {rc}")
                label = f"{name}<R={r},{mode}>"
                info[label] = dict(zip(("registers", "smem_bytes", "blocks_per_sm", "local_bytes"),
                                       vals))
                check(vals[3] == 0, f"{label}: {vals[3]} bytes of local memory a thread")
                print(f"[{card}]   {label}: {vals[0]} registers, {vals[1]} bytes of dynamic "
                      f"shared memory, {vals[2]} blocks an SM, {vals[3]} bytes local")
    for mode in KL_MODES:   # K3's instances (nmf_kl_info)
        for r in (1, 2, 4, 8, 16):
            vals = (ctypes.c_int * 4)()
            rc = lib.nmf_kl_info(MODES.index(mode), 16 * r, vals)
            label = f"kl_partial<R={r},{mode}>"
            check(rc == 0, f"nmf_kl_info {label}: CUDA error {rc}")
            info[label] = dict(zip(("registers", "smem_bytes", "blocks_per_sm", "local_bytes"), vals))
            check(vals[3] == 0, f"{label}: {vals[3]} bytes of local memory a thread")
            print(f"[{card}]   {label}: {vals[0]} registers, {vals[1]} bytes of dynamic "
                  f"shared memory, {vals[2]} blocks an SM, {vals[3]} bytes local")
    return info


def _operands(m, n, k):
    rng = np.random.RandomState(m + n + k)
    return tuple(
        torch.from_numpy(np.maximum(rng.rand(*s).astype(np.float32), np.float32(EPS))).cuda()
        for s in ((m, k), (k, n), (m, n))
    )


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _where(name, w, h, label=""):
    return f"{name} {label}{w.shape[0]}x{h.shape[1]}x{w.shape[1]}"


def _run_pair(kern, plain, w, h, x, where):
    """(kernel result, plain result) on the same tensors, once the kernel's
    dtype, finiteness and a bitwise-identical second call are checked."""
    out1 = kern(w, h, x)
    torch.cuda.synchronize()
    out2 = kern(w, h, x)
    torch.cuda.synchronize()
    ref = plain(w, h, x)
    torch.cuda.synchronize()
    check(out1.dtype == ref.dtype, f"{where}: dtype {out1.dtype} vs plain {ref.dtype}")
    check(torch.equal(_bits(out1), _bits(out2)), f"{where}: second call not bitwise identical")
    check(bool(torch.isfinite(out1).all()), f"{where}: non-finite output")
    return out1, ref


def _check_kernel(name, kern, plain, w, h, x, tol=F32_TOL):
    """Kernel vs plain on the same tensors, and a bitwise rerun; returns
    (max abs error, description)."""
    rtol, atol, cost_rtol = tol
    where = _where(name, w, h)
    out1, ref = _run_pair(kern, plain, w, h, x, where)
    err = (out1.float() - ref.float()).abs()
    max_err = float(err.max())
    if name == "kl_cost":
        rel = max_err / abs(float(ref))
        ok, what = rel <= cost_rtol, f"rel err {rel} (limit {cost_rtol})"
    else:
        worst = float((err - rtol * ref.float().abs()).max())
        ok = worst <= atol
        what = (f"max abs err {max_err}, worst excess over rtol {rtol}: {worst} "
                f"(atol {atol})")
    check(ok, f"{where}: {what}")
    return max_err, what


def _pairs(prec=None):
    """name -> (kernel, plain) under ``prec``, X dense or a (codes, scales)
    pair."""
    from nmf_tpu_torch.ops import mu
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.quant import dequantize
    from nmf_tpu_torch.utils.config import Precision

    prec = prec or Precision()

    def dense(x):
        return dequantize(*x) if isinstance(x, tuple) else x

    return {
        "update_h": (lambda w, h, x: fused_mu.update_h_fused(w, h, x, precision=prec),
                     lambda w, h, x: mu.update_h(w, h, dense(x), precision=prec)),
        "update_w": (lambda w, h, x: fused_mu.update_w_fused(w, h, x, precision=prec),
                     lambda w, h, x: mu.update_w(w, h, dense(x), precision=prec)),
        "kl_cost": (lambda w, h, x: fused_mu.kl_cost_fused(x, w, h, precision=prec),
                    lambda w, h, x: fused_mu.kl_cost_plain(x, w, h, precision=prec)),
    }


def _mu_bound(name, w, h, x, prec):
    """The bound of one K1, K2 or K3 call on these operands: two GEMMs of
    M x N x K a half-update, one for the cost (three bf16 passes each under
    split3, which K3 does not take), X (codes and scales), W and H read
    once, the result written once."""
    m, k = w.shape
    n = h.shape[1]
    split3 = prec.matmul_dtype == "float32_fast" and name != "kl_cost"
    kind = "float32" if prec.matmul_dtype == "float32" or not (
        split3 or prec.matmul_dtype == "bfloat16") else "bfloat16"
    flops = (3 if split3 else 1) * (1 if name == "kl_cost" else 2) * 2 * m * n * k
    x_bytes = sum(t.numel() * t.element_size() for t in (x if isinstance(x, tuple) else (x,)))
    out_bytes = {"update_h": k * n * h.element_size(), "update_w": m * k * w.element_size(),
                 "kl_cost": 4}[name]
    nbytes = x_bytes + (w.numel() + h.numel()) * w.element_size() + out_bytes
    return bound(flops, nbytes, kind)


def phase_kernels(card, out):
    print(f"[{card}] phase 2: kernels (float32) vs plain torch on the card")
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils.config import Precision

    pairs = _pairs()
    stats = out["kernels"]
    for si, (m, n, k) in enumerate(SHAPES):
        w, h, x = _operands(m, n, k)
        for name, (kern, plain) in pairs.items():
            max_err, what = _check_kernel(name, kern, plain, w, h, x)
            kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
            print(f"[{card}] {name:8s} {m}x{n}x{k}: kernel {kms} ms, plain {pms} ms, "
                  f"{what}, bitwise-repeatable")
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], max_err)
            if si == 0:  # the main path's shape
                st["ms"], st["plain_ms"] = kms, pms
                st["bound_ms"], st["bound_by"] = _mu_bound(name, w, h, x, Precision())
        inst = _check_kl_mode(pairs["kl_cost"][0], w, h, x, Precision(), _where("kl_cost", w, h))
        if si == 0:   # which instance the main path's K3 ran
            stats["kl_cost"].update(impl="simt", instance=inst)
            print(f"[{card}] [float32] {m}x{n}x{k}: K3 ran {inst} (the library's launches per Mode)")
        if si == 0:   # which pass-1 instance the main path's K1/K2 ran
            impls = _check_impls(lambda: [pairs[nm][0](w, h, x) for nm in ("update_h", "update_w")],
                                 Precision(), f"[float32] {m}x{n}x{k}")
            for name, impl in impls.items():
                stats[name]["impl"] = impl
            print(f"[{card}] [float32] {m}x{n}x{k}: K1/K2 pass 1 ran {impls}")
    # every K chunk width and several chunks, up to the rank ceiling; K3
    # also where its walk has edges
    for m, n, k in [*COVERAGE_SHAPES, *KL_SHAPES]:
        w, h, x = _operands(m, n, k)
        for name, (kern, plain) in pairs.items():
            if (m, n, k) in KL_SHAPES and name != "kl_cost":
                continue
            max_err, what = _check_kernel(name, kern, plain, w, h, x)
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], max_err)
            if name == "kl_cost":
                what += f", {_check_kl_mode(kern, w, h, x, Precision(), _where(name, w, h))}"
            print(f"[{card}] {name:8s} {m}x{n}x{k}: {what}, bitwise-repeatable")
    # above the rank ceiling the wrappers take the plain ops by rule
    k = fused_mu.MAX_FUSED_K + 8
    w, h, x = _operands(64, 96, k)
    launches = dict(fused_mu.LAUNCHES)
    plain_before = fused_mu.PLAIN_CALLS["update_h"]
    fused_mu.update_h_fused(w, h, x)
    check(fused_mu.PLAIN_CALLS["update_h"] == plain_before + 1
          and fused_mu.LAUNCHES == launches, f"K={k} did not take the plain ops")
    print(f"[{card}] K={k} > MAX_FUSED_K: plain ops by the rank rule, no launch")


class ModeCheck(NamedTuple):
    prec: object            # Precision of the mode
    state: torch.dtype      # W and H
    xform: str              # X: "f32", "bf16" or "int8" (codes, scales)
    limits: tuple           # (max, spread, cost): see MODE_LIMITS
    control: object = None  # Precision of a kernel that skips the mode's rounding
    controlled: tuple = ()  # the kernels whose arithmetic the control changes


def _modes():
    """mode -> ModeCheck.  A control is the same kernel under a policy that
    skips the mode's rounding (or split), on the same operands: it must
    fail the limit, so each run shows the limit can see that fault."""
    from nmf_tpu_torch.utils.config import BF16_FULL, Precision

    f32 = Precision()
    bf16_state = dataclasses.replace(BF16_FULL, state_dtype="bfloat16")
    gemms = ("update_h", "update_w")
    return {
        "bfloat16": ModeCheck(Precision("bfloat16"), torch.float32, "f32",
                              MODE_LIMITS["bfloat16"], f32, (*gemms, "kl_cost")),
        # K3 is true f32 under float32_fast: the control changes K1/K2 only
        "float32_fast": ModeCheck(Precision("float32_fast"), torch.float32, "f32",
                                  MODE_LIMITS["float32_fast"], f32, gemms),
        "x_bfloat16": ModeCheck(Precision(x_dtype="bfloat16"), torch.float32, "bf16",
                                MODE_LIMITS["f32_gemm"]),
        "x_int8": ModeCheck(Precision(x_dtype="int8"), torch.float32, "int8",
                            MODE_LIMITS["f32_gemm"]),
        # float32_fast on the other storages of its tensor-core kernels: bf16
        # X (W and H exposed as above), and bf16 state (split exactly, lo 0)
        # with int8 X, which no control can tell from f32 GEMMs
        "float32_fast_x_bf16": ModeCheck(Precision("float32_fast", x_dtype="bfloat16"),
                                         torch.float32, "bf16", MODE_LIMITS["float32_fast"],
                                         f32, gemms),
        "float32_fast_bf16_state": ModeCheck(Precision("float32_fast", "bfloat16", "int8"),
                                             torch.bfloat16, "int8", MODE_LIMITS["bf16_state"]),
        # bf16 W and H are their own rounding: the control skips only Z's,
        # which K3 does not form
        "bf16_full_state": ModeCheck(bf16_state, torch.bfloat16, "bf16",
                                     MODE_LIMITS["bf16_state"],
                                     dataclasses.replace(bf16_state, matmul_dtype="float32"),
                                     gemms),
    }


def _exposed(rng, shape, mode):
    """W or H values on which a kernel that skips ``mode``'s rounding is off
    by a bias of one sign, where on uniform operands the errors mostly
    cancel in the sums (and in the cost, below one f32 ulp at some shapes).

    bfloat16: b * (1 + 2**-10), b bf16-exact, which rounds to b, 2**-10 low
    in every operand (W H 2**-9 low).  float32_fast: hi + lo, hi a power of
    two and lo = hi * 2**-8 * u with u in [0.5, 1) on 8 bits, which bf16
    splits exactly into (hi, lo); split3 drops lo * lo' = 2**-16 u u' of
    every product (W H ~8.6e-6 low)."""
    if mode == "bfloat16":
        b = torch.from_numpy(np.maximum(rng.rand(*shape).astype(np.float32), np.float32(EPS)))
        return (b.to(torch.bfloat16).float() * (1 + 2.0 ** -10)).cuda()
    hi = np.exp2(-rng.randint(0, 4, shape)).astype(np.float32)
    u = (128 + rng.randint(0, 128, shape)).astype(np.float32) / 256
    return torch.from_numpy(hi + hi * np.float32(2.0 ** -8) * u).cuda()


def _mode_operands(m, n, k, mode, spec):
    from nmf_tpu_torch.ops.quant import quantize_columns

    w, h, x = _operands(m, n, k)
    policy = spec.prec.matmul_dtype
    if spec.state == torch.float32 and policy in ("bfloat16", "float32_fast"):
        rng = np.random.RandomState(m + n + k)
        w, h = _exposed(rng, (m, k), policy), _exposed(rng, (k, n), policy)
    w, h = w.to(spec.state), h.to(spec.state)
    if spec.xform == "bf16":
        x = x.to(torch.bfloat16)
    elif spec.xform == "int8":
        x = quantize_columns(x, EPS)
    return w, h, x


def _mode_err(out, ref):
    """(largest relative error, spread, largest bf16 ulp distance) of a
    result against its plain version.  The spread is the RMS relative error
    of an f32 result, and for a bf16 result the share of entries that
    differ (the entries are positive, so their bits count ulps)."""
    rel = (out.double() - ref.double()).abs() / ref.double().abs()
    if out.dtype == torch.bfloat16:
        ulps = (out.view(torch.int16).int() - ref.view(torch.int16).int()).abs()
        return float(rel.max()), float((ulps > 0).double().mean()), int(ulps.max())
    return float(rel.max()), float(rel.square().mean().sqrt()), 0


def phase_modes(card, out):
    print(f"[{card}] phase 3: precision modes of K1-K3 vs plain torch on the card")
    stats = out["kernels"]
    for mode, spec in _modes().items():
        pairs = _pairs(spec.prec)
        controls = _pairs(spec.control) if spec.control else {}
        max_limit, spread_limit, cost_limit = spec.limits
        # K1-K3 at MODE_SHAPES, then K3 alone at the edges of its walk
        for si, (m, n, k) in enumerate([*MODE_SHAPES, *KL_MODE_SHAPES]):
            w, h, x = _mode_operands(m, n, k, mode, spec)
            for name, (kern, plain) in pairs.items():
                if si >= len(MODE_SHAPES) and name != "kl_cost":
                    continue
                where = _where(name, w, h, f"[{mode}] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                err, spread, ulps = _mode_err(res, ref)
                spread_name = ("share of entries differing" if res.dtype == torch.bfloat16
                               else "rms rel err")
                if name == "kl_cost":
                    limit, measured = cost_limit, err
                    inst = _check_kl_mode(kern, w, h, x, spec.prec, where)
                    what = f"rel err {err} (limit {limit}), {inst}"
                else:
                    limit, measured = spread_limit, spread
                    check(ulps <= 1, f"{where}: an entry {ulps} bf16 ulps from plain")
                    check(max_limit is None or err <= max_limit,
                          f"{where}: max rel err {err} (limit {max_limit})")
                    what = (f"max rel err {err} (limit {max_limit}), {spread_name} "
                            f"{spread} (limit {spread_limit})")
                check(limit is None or measured <= limit, f"{where}: {what}")
                # "err" is what "limit" bounds: the spread of factors, the
                # relative error of the cost
                ms = stats[name]["modes"].setdefault(
                    mode, {"max_abs_err": 0.0, "max_rel_err": 0.0, "err": 0.0, "limit": limit})
                ms["max_abs_err"] = max(ms["max_abs_err"], float((res.float() - ref.float()).abs().max()))
                ms["max_rel_err"] = max(ms["max_rel_err"], err)
                ms["err"] = max(ms["err"], measured)
                if name in spec.controlled:
                    c_err, c_spread, _ = _mode_err(controls[name][0](w, h, x), ref)
                    c_measured = c_err if name == "kl_cost" else c_spread
                    check(c_measured > limit, f"{where}: the control ({spec.control.matmul_dtype} "
                          f"GEMMs) reads {c_measured}, within the limit {limit}")
                    ms["control_min"] = min(ms.get("control_min", c_measured), c_measured)
                    what += f"; control ({spec.control.matmul_dtype} GEMMs) {c_measured}"
                if si == 0:  # the main path's shape, timed
                    kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
                    b_ms, b_by = _mu_bound(name, w, h, x, spec.prec)
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
                    if name == "kl_cost":
                        ms.update(impl=_kl_impl(inst), instance=inst)
                    print(f"[{card}] {where}: kernel {kms} ms, plain {pms} ms, bound {b_ms} ms "
                          f"({b_by}), {what}, bitwise-repeatable")
                else:
                    print(f"[{card}] {where}: {what}, bitwise-repeatable")
            if si == 0:   # which pass-1 instance K1/K2 ran, from a trace
                impls = _check_impls(lambda: [pairs[nm][0](w, h, x) for nm in ("update_h", "update_w")],
                                     spec.prec, f"[{mode}] {m}x{n}x{k}")
                for name, impl in impls.items():
                    stats[name]["modes"][mode]["impl"] = impl
                print(f"[{card}] [{mode}] {m}x{n}x{k}: K1/K2 pass 1 ran {impls} (the library's "
                      "launches per Mode)")


def phase_quant(card, out):
    print(f"[{card}] phase 4: the quantizer on the card vs the NumPy twin")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import quant

    x = nt.fixtures.as_seen_by_solver(nt.fixtures.reference_fixture_arrays()["X"])
    x = np.maximum(x, np.float32(EPS))   # the load-time clamp
    cases = [
        ("columns", x, lambda a: quant.quantize_columns(a, EPS),
         lambda a: quant.quantize_columns_np(a, EPS)),
        # 4000 rows in blocks of 300: normalised to 14 blocks of 286 rows,
        # the last one padded by 4 (nmf_tpu/ops/quant.py:128-137)
        ("rowblocks 300", np.ascontiguousarray(x[:4000]),
         lambda a: quant.quantize_rowblocks(a, EPS, 300),
         lambda a: quant.quantize_rowblocks_np(a, EPS, 300)),
    ]
    for label, xa, on_card, on_host in cases:
        q, s = (t.cpu().numpy() for t in on_card(torch.from_numpy(xa).cuda()))
        qn, sn = on_host(xa)
        check(q.dtype == np.uint8 and q.shape == qn.shape, f"quant {label}: codes {q.dtype} {q.shape}")
        check(q.tobytes() == qn.tobytes(), f"quant {label}: codes differ from the NumPy twin "
              f"at {int((q != qn).sum())} entries")
        check(s.tobytes() == sn.tobytes(), f"quant {label}: scales differ from the NumPy twin")
        print(f"[{card}] quantizer {label} {q.shape}: codes and {s.shape} scales "
              f"byte-identical to the NumPy twin")


def _cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    return subprocess.run([sys.executable, "-m", "nmf_tpu_torch", *args],
                          check=True, cwd=cwd, env=env)


# phase 5's runs beside the tiers: tag -> run's inputs and flags
CLI_FLAG_RUNS = {"nndsvda": ["X.bin", "--rank", "128"],
                 "accelerate": ["X.bin", "W.bin", "H.bin", "--accelerate"],
                 "strict": ["X.bin", "W.bin", "H.bin", "--strict-compat"],
                 "strict_rerun": ["X.bin", "W.bin", "H.bin", "--strict-compat"]}


def phase_cli(card, tmp, out):
    print(f"[{card}] phase 5: reference pipeline through the CLI, every tier")
    _cli(["gen", "."], tmp)
    # every tier's run and the solver flags' runs as subprocesses at once
    runs = {tier: ["run", "X.bin", "W.bin", "H.bin", *flags] for tier, flags in TIERS.items()}
    runs.update({tag: ["run", *args] for tag, args in CLI_FLAG_RUNS.items()})
    for tag, args in runs.items():
        args += ["-o", f"W_{tag}.bin", f"H_{tag}.bin", "--jsonl", f"{tag}.jsonl"]
    t0 = time.perf_counter()
    _cli_all(runs, tmp)
    wall = time.perf_counter() - t0
    out["cli"]["wall_s"] = wall
    for tier in TIERS:
        rec = json.loads(pathlib.Path(tmp, f"{tier}.jsonl").read_text().splitlines()[-1])
        costs = [c["cost"] for c in rec["checks"]]
        check(rec["iterations"] == 200, f"CLI {tier}: ran {rec['iterations']} iterations")
        check(len(costs) == 8, f"CLI {tier}: made {len(costs)} checks")
        check(all(b < a for a, b in zip(costs, costs[1:])),
              f"CLI {tier}: costs not decreasing: {costs}")
        rel = abs(rec["final_cost"] - PIN_COST) / PIN_COST
        if tier in ("float32", "float32_fast"):
            check(rel <= 1e-4, f"CLI {tier}: final cost {rec['final_cost']} vs {PIN_COST}: rel {rel}")
        size = pathlib.Path(tmp, f"W_{tier}.bin").stat().st_size
        check(size == 8 + 4096 * 128 * 4, f"CLI {tier}: W_{tier}.bin is {size} bytes")
        out["cli"][tier] = rec["final_cost"]
        print(f"[{card}] CLI {tier}: 200 iterations, 8 decreasing checks, final cost "
              f"{rec['final_cost']} (rel {rel} to the pin), solve {rec['seconds']} s = "
              f"{rec['iters_per_sec']} it/s")
    print(f"[{card}] CLI: {len(runs)} run processes at once (every tier and the solver "
          f"flags), {wall} s of wall")
    _cli_solver_flags(card, tmp, out)


def _cli_files(tmp, tag):
    import nmf_tpu_torch as nt

    return tuple(nt.read_matrix(os.path.join(tmp, f"{f}_{tag}.bin")) for f in "WH")


def _cli_solver_flags(card, tmp, out):
    """The files of ``run X.bin --rank 128`` at the default init (nndsvda),
    ``run --accelerate`` and ``run --strict-compat`` on the reference
    fixtures (``CLI_FLAG_RUNS``, run by :func:`phase_cli`): the first two
    byte-equal to the in-process solve, the third de-padded and byte-equal
    on a rerun."""
    import nmf_tpu_torch as nt

    x, w, h = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XWH")
    runs = CLI_FLAG_RUNS
    recs = {}
    for tag in runs:   # run by phase_cli, with the tiers
        recs[tag] = json.loads(pathlib.Path(tmp, f"{tag}.jsonl").read_text().splitlines()[-1])
        check(recs[tag]["iterations"] == 200, f"CLI {tag}: {recs[tag]['iterations']} iterations")
    w0, h0 = nt.nndsvd_init(x, 128, "nndsvda")
    cfg = nt.reference_preset()
    for tag, (w_in, h_in, c) in {"nndsvda": (w0, h0, cfg),
                                 "accelerate": (w, h, dataclasses.replace(cfg, accelerate=True))
                                 }.items():
        res = nt.solve(x, w_in, h_in, c, device="cuda")
        w_out, h_out = _cli_files(tmp, tag)
        check(w_out.tobytes() == res.w.cpu().numpy().tobytes()
              and h_out.tobytes() == res.h.cpu().numpy().tobytes(),
              f"CLI {tag}: files differ from the in-process solve")
        costs = [c_["cost"] for c_ in recs[tag]["checks"]]
        check(len(costs) == 8 and all(b <= a for a, b in zip(costs, costs[1:])),
              f"CLI {tag}: checks {costs}")
        out["cli"][tag] = recs[tag]["final_cost"]
        print(f"[{card}] CLI run {' '.join(runs[tag])}: files byte-equal to the in-process solve, "
              f"final cost {recs[tag]['final_cost']}, history {costs}, {recs[tag]['iters_per_sec']} it/s")
    strict, again = _cli_files(tmp, "strict"), _cli_files(tmp, "strict_rerun")
    check(strict[0].shape == (4096, 128) and strict[1].shape == (128, 350),
          f"CLI strict: shapes {strict[0].shape}, {strict[1].shape}")
    check(all(a.tobytes() == b.tobytes() for a, b in zip(strict, again)),
          "CLI strict: files differ on a rerun")
    out["cli"]["strict"] = recs["strict"]["final_cost"]
    print(f"[{card}] CLI run --strict-compat: de-padded to 4096x128 / 128x350, byte-identical on a "
          f"rerun, final cost {recs['strict']['final_cost']} (over the padded 4096x352 buffers; "
          f"rel {abs(recs['strict']['final_cost'] - PIN_COST) / PIN_COST} to the pin)")


def _tier_configs():
    """tier -> (SolveConfig, ran through the CLI): the CLI tiers, parsed as
    the CLI parses them, and bf16 state, which only the API reaches."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.cli import build_parser

    tiers = {}
    for tier, flags in TIERS.items():
        args = build_parser().parse_args(["run", "X.bin", *flags])
        prec = nt.Precision(matmul_dtype=args.dtype, x_dtype=args.x_dtype,
                            x_quant_rows=args.x_quant_rows)
        tiers[tier] = (dataclasses.replace(nt.reference_preset(), precision=prec), True)
    prec = _modes()["bf16_full_state"][0]
    tiers["bf16_full_state"] = (dataclasses.replace(nt.reference_preset(), precision=prec), False)
    return tiers


def phase_inprocess(card, tmp, out):
    print(f"[{card}] phase 6: reference pipeline in-process through solve, every tier")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    x, w, h = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XWH")
    for tier, (cfg, via_cli) in _tier_configs().items():
        fused_mu.reset_counts()
        t0 = time.perf_counter()
        res = nt.solve(x, w, h, cfg, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, plain_calls = dict(fused_mu.LAUNCHES), dict(fused_mu.PLAIN_CALLS)
        # the default path: the launches follow the backend rule's choice
        want = _launches(**({"update_h": 200, "update_w": 200, "kl_cost": 8}
                            if _auto_choice(cfg, 4096, 128, 350) == "pallas" else {}))
        check(launches == want, f"{tier}: launches {launches}, expected {want}")
        check(not any(plain_calls.values()), f"{tier}: plain calls on the card {plain_calls}")
        out["launches"][tier] = launches
        hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
        check(int(res.iterations) == 200 and hist.shape == (8,), f"{tier}: 200 iterations / 8 checks")
        check(bool(np.all(np.diff(hist) < 0)), f"{tier}: costs not decreasing: {hist}")
        cost = float(res.cost)
        w1, h1 = (t.cpu().float().numpy() for t in (res.w, res.h))
        res2 = nt.solve(x, w, h, cfg, device="cuda")
        check(w1.tobytes() == res2.w.cpu().float().numpy().tobytes(), f"{tier}: W differs on a rerun")
        check(h1.tobytes() == res2.h.cpu().float().numpy().tobytes(), f"{tier}: H differs on a rerun")
        if via_cli:
            wout = nt.read_matrix(os.path.join(tmp, f"W_{tier}.bin"))
            hout = nt.read_matrix(os.path.join(tmp, f"H_{tier}.bin"))
            check(wout.tobytes() == w1.tobytes() and hout.tobytes() == h1.tobytes(),
                  f"{tier}: CLI output files differ from the in-process factors")
        plain = nt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"), device="cuda")
        c_plain = float(plain.cost)
        rel = abs(cost - c_plain) / abs(c_plain)
        limit = 1e-3 if cfg.precision.matmul_dtype == "bfloat16" else 1e-4
        check(rel <= limit, f"{tier}: cost {cost} vs plain (backend='jnp') {c_plain}: rel {rel}")
        if tier in ("float32", "float32_fast"):
            pin = abs(cost - PIN_COST) / PIN_COST
            check(pin <= 1e-4, f"{tier}: final cost {cost} vs {PIN_COST}: rel {pin}")
        print(f"[{card}] solve {tier}: launches {launches}, cost {cost} (plain {c_plain}, "
              f"rel {rel}, limit {limit}), history {hist.tolist()}, {secs} s (first solve of "
              f"the tier), byte-identical on rerun{' and vs the CLI files' if via_cli else ''}")


def _split_exposed(g, shape):
    """Phase 3's ``float32_fast`` W or H (``_exposed``), made on the card:
    hi + lo, hi a power of two and lo = hi * 2**-8 * u, u in [0.5, 1) on 8
    bits."""
    hi = torch.exp2(-torch.randint(0, 4, shape, generator=g, device="cuda").float())
    u = (128 + torch.randint(0, 128, shape, generator=g, device="cuda")).float() / 256
    return hi + hi * 2.0 ** -8 * u


def _walk_operands(m, n, k, mode, spec):
    """A long-walk check's operands, made on the card from a seed: X
    uniform; f32 state: W and H as phase 3's for ``mode`` (``_exposed``:
    ``bfloat16`` 2**-10 above bf16-exact values, ``float32_fast`` split
    exactly into (hi, lo)); bf16 state: X as phase 9a's (``_num_operands``:
    a skipped rounding of Z shows)."""
    g = torch.Generator(device="cuda").manual_seed(m + n + k)
    w, h, x = (torch.rand(s, generator=g, device="cuda").clamp_(min=EPS)
               for s in ((m, k), (k, n), (m, n)))
    if spec.state == torch.bfloat16:
        w, h = w.bfloat16(), h.bfloat16()
        return w, h, (x.bfloat16().double() * (1 + 2.0 ** -10) * (w.double() @ h.double())).float()
    if mode == "float32_fast":
        return _split_exposed(g, (m, k)), _split_exposed(g, (k, n)), x
    return w.bfloat16().float() * (1 + 2.0 ** -10), h.bfloat16().float() * (1 + 2.0 ** -10), x


def _walk_tiles(name, m, n, k):
    """Tiles a K1 (update_h) or K2 block walks: the planner's tiles_per_split."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    chunks = -(-k // fused_mu.chunk_width(k))
    m_tiles, n_tiles = -(-m // fused_mu.TILE), -(-n // fused_mu.TILE)
    if name == "update_h":
        return fused_mu.plan_split(n_tiles, chunks, m_tiles)[1]
    return fused_mu.plan_split(m_tiles, chunks, n_tiles)[1]


def _check_long_walks(card, out):
    """``bfloat16`` and ``float32_fast`` K1/K2, one call each against its
    plain version on the same operands, where a block's contraction walks
    farthest (LONG_WALKS): within the mode's ``MODE_LIMITS`` (max and RMS
    relative error), the f32-GEMM control failing the RMS limit, bitwise on
    a rerun.  f32 state: the full update (phase 3's ``bfloat16`` and
    ``float32_fast``); bf16 state (``bfloat16``): the f32 numerator
    (``numerator_only``, phase 9a's ``bf16_state``), which shows a drift
    the bf16 result would round away."""
    checks = {("bfloat16", "f32 state"): (_modes()["bfloat16"], _pairs),
              ("bfloat16", "bf16 state"): (_num_modes()["bf16_state"], _num_pairs),
              ("float32_fast", "f32 state"): (_modes()["float32_fast"], _pairs)}
    for m, n, k in LONG_WALKS:
        for (mode, label), (spec, pairs_of) in checks.items():
            max_limit, spread_limit, _ = MODE_LIMITS[mode]
            w, h, x = _walk_operands(m, n, k, mode, spec)
            pairs, controls = pairs_of(spec.prec), pairs_of(spec.control)
            for name, (kern, plain) in pairs.items():
                if name not in ("update_h", "update_w"):
                    continue
                per = _walk_tiles(name, m, n, k)
                where = _where(name, w, h, f"[{mode}, {label}, {per} tiles a split] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                check(res.dtype == torch.float32, f"{where}: dtype {res.dtype}")
                err, spread, _ = _mode_err(res, ref)
                c_spread = _mode_err(controls[name][0](w, h, x), ref)[1]
                del res, ref
                what = (f"max rel err {err} (limit {max_limit}), rms rel err {spread} (limit "
                        f"{spread_limit}); control (f32 GEMMs) {c_spread}")
                check(err <= max_limit and spread <= spread_limit, f"{where}: {what}")
                check(c_spread > spread_limit, f"{where}: the control reads {c_spread}, within "
                      f"the limit {spread_limit}")
                out["kernels"][name]["long_walks"][f"{mode} {label} {m}x{n}x{k}"] = {
                    "tiles_per_split": per, "max_rel_err": err, "rms_rel_err": spread,
                    "control_rms": c_spread}
                print(f"[{card}] {where}: {what}, bitwise-repeatable")
            del w, h, x
            torch.cuda.empty_cache()


def phase_flagship(card, out):
    print(f"[{card}] phase 7: flagship 10240x10240, K=256, 50 iterations, float32, bfloat16 "
          "and float32_fast")
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils.metrics import flops_per_iter

    m = n = 10240
    k = 256
    iters = 50
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((m, n), generator=g, device="cuda")
    w = torch.rand((m, k), generator=g, device="cuda")
    h = torch.rand((k, n), generator=g, device="cuda")
    # one call of K1 and K2 under each GEMM policy, timed as in phase 2 with
    # fewer samples (a call takes milliseconds here)
    for dtype in ("float32", "bfloat16", "float32_fast"):
        pairs = _pairs(nt.Precision(dtype))
        impls = _check_impls(lambda: [pairs[nm][0](w, h, x) for nm in ("update_h", "update_w")],
                             nt.Precision(dtype), f"flagship [{dtype}]")
        for name in ("update_h", "update_w"):
            kern, plain = pairs[name]
            kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x), 5, 5)
            b_ms, b_by = _mu_bound(name, w, h, x, nt.Precision(dtype))
            out["kernels"][name]["flagship"][dtype] = {"ms": kms, "plain_ms": pms, "bound_ms": b_ms,
                                                       "bound_by": b_by, "impl": impls[name]}
            print(f"[{card}] flagship {name} [{dtype}] {m}x{n}x{k}: kernel {kms} ms, "
                  f"plain {pms} ms, bound {b_ms} ms ({b_by}), {impls[name]} "
                  f"({2 * 2 * m * n * k / kms / 1e9} TFLOP/s)")
        # K3 under the same policy: checked, its instance read, timed
        kern, plain = pairs["kl_cost"]
        where = f"flagship kl_cost [{dtype}] {m}x{n}x{k}"
        res, ref = _run_pair(kern, plain, w, h, x, where)
        rel = _mode_err(res, ref)[0]
        check(rel <= MODE_LIMITS["f32_gemm"][2], f"{where}: rel err {rel} (limit 1e-5)")
        inst = _check_kl_mode(kern, w, h, x, nt.Precision(dtype), where)
        kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x), 5, 5)
        b_ms, b_by = _mu_bound("kl_cost", w, h, x, nt.Precision(dtype))
        out["kernels"]["kl_cost"]["flagship"][dtype] = {
            "ms": kms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by, "impl": _kl_impl(inst),
            "instance": inst, "rel_err": rel}
        print(f"[{card}] {where}: kernel {kms} ms, plain {pms} ms, bound {b_ms} ms ({b_by}), {inst}, "
              f"rel err {rel}, {2 * m * n * k / kms / 1e9} TFLOP/s of its recon")
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 1e-3), ("float32_fast", 1e-4)):
        base = nt.SolveConfig(max_iter=iters, check_every=25, precision=nt.Precision(dtype))
        results = {}
        for backend in ("pallas", "jnp"):   # warm each path once (allocator, cuBLAS)
            nt.solve(x, w, h, dataclasses.replace(base, backend=backend, max_iter=1),
                     device="cuda")
        torch.cuda.synchronize()
        for backend in ("pallas", "jnp", "jnp", "pallas"):
            fused_mu.reset_counts()
            t0 = time.perf_counter()
            res = nt.solve(x, w, h, dataclasses.replace(base, backend=backend), device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            cost = float(res.cost)
            if backend == "pallas":   # 50 iterations, a cost every 25: 50/50/2
                want = _launches(update_h=iters, update_w=iters, kl_cost=iters // 25)
                check(fused_mu.LAUNCHES == want and not any(fused_mu.PLAIN_CALLS.values()),
                      f"flagship {dtype}: launches {fused_mu.LAUNCHES}, plain calls "
                      f"{fused_mu.PLAIN_CALLS}, expected {want}")
                out["launches"][f"flagship {dtype}"] = dict(fused_mu.LAUNCHES)
            check(np.isfinite(cost) and int(res.iterations) == iters,
                  f"flagship {dtype} {backend}: cost {cost}")
            results.setdefault(backend, []).append((secs, cost))
        c_k, c_p = results["pallas"][0][1], results["jnp"][0][1]
        rel = abs(c_k - c_p) / abs(c_p)
        check(rel <= limit, f"flagship {dtype}: cost kernel {c_k} vs plain {c_p}: rel {rel}")
        for backend, label in (("pallas", "kernels"), ("jnp", "plain (cuBLAS f32)")):
            for secs, cost in results[backend]:
                ips = iters / secs
                tf = flops_per_iter(m, k, n) * ips / 1e12
                out["flagship"].setdefault(f"{dtype} {label}", []).append(ips)
                print(f"[{card}] flagship {dtype} {label}: {secs} s for {iters} iterations + "
                      f"2 costs, {ips} it/s, {tf} TFLOP/s, final cost {cost}")
        print(f"[{card}] flagship {dtype} costs agree: rel {rel} (limit {limit})")
    del x, w, h
    _check_long_walks(card, out)
    _check_kl_long_walks(card, out)


def _check_kl_long_walks(card, out):
    """K3 where its blocks walk farthest (LONG_WALKS: 40, 17 and 303 tiles
    a split) on phase 3's ``bfloat16`` operands (2**-10 above bf16-exact
    values): ``bfloat16`` (BF16) with the f32-recon control failing, and
    ``float32`` and ``float32_fast`` (F32), each within cost rel 1e-5 of
    ``kl_cost_plain``, bitwise on a rerun."""
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils.config import Precision

    limit = MODE_LIMITS["bfloat16"][2]
    spec = _modes()["bfloat16"]
    for m, n, k in LONG_WALKS:
        w, h, x = _walk_operands(m, n, k, "bfloat16", spec)
        per = fused_mu.kl_split(m, n, k)[2]
        for dtype in ("bfloat16", "float32", "float32_fast"):
            prec = Precision(dtype)
            kern, plain = _pairs(prec)["kl_cost"]
            where = _where("kl_cost", w, h, f"[{dtype}, {per} tiles a split] ")
            res, ref = _run_pair(kern, plain, w, h, x, where)
            rel = _mode_err(res, ref)[0]
            inst = _check_kl_mode(kern, w, h, x, prec, where)
            what = f"rel err {rel} (limit {limit}), {inst}"
            check(rel <= limit, f"{where}: {what}")
            entry = {"tiles_per_split": per, "rel_err": rel, "instance": inst}
            if dtype == "bfloat16":
                c_rel = _mode_err(_pairs(spec.control)["kl_cost"][0](w, h, x), ref)[0]
                check(c_rel > limit, f"{where}: the control (f32 recon) reads {c_rel}, within "
                      f"the limit {limit}")
                entry["control_rel"] = c_rel
                what += f"; control (f32 recon) {c_rel}"
            out["kernels"]["kl_cost"]["long_walks"][f"{dtype} {m}x{n}x{k}"] = entry
            print(f"[{card}] {where}: {what}, bitwise-repeatable")
        del w, h, x
        torch.cuda.empty_cache()


def tile_problem(m, k, n, tile, occ_frac, seed=0):
    """Clustered-sparse X and dense W, H: the generator of the JAX package's
    tile-sparse benchmark (benchmarks/tile_sparse_tune.py:29-41), copied
    because its harness imports the JAX package."""
    rng = np.random.RandomState(seed)
    mb, nb = m // tile, n // tile
    occ = rng.rand(mb, nb) < occ_frac
    x = np.zeros((m, n), np.float32)
    for i, j in zip(*np.nonzero(occ)):
        blk = rng.rand(tile, tile).astype(np.float32)
        blk[rng.rand(tile, tile) < 0.5] = 0
        x[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = blk
    w = rng.rand(m, k).astype(np.float32)
    h = rng.rand(k, n).astype(np.float32)
    return x, w, h


def _fixed_tile_problem(m, k, n, tile, blocks, seed, zero_frac):
    """X with the given occupied blocks (their entries zeroed at random),
    W and H clamped: the problems of tests/test_pallas.py and
    tests/test_sparse.py."""
    rng = np.random.RandomState(seed)
    x = np.zeros((m, n), np.float32)
    for i, j in blocks:
        blk = rng.rand(*tile).astype(np.float32)
        blk[rng.rand(*tile) < zero_frac] = 0
        rows, cols = slice(i * tile[0], (i + 1) * tile[0]), slice(j * tile[1], (j + 1) * tile[1])
        x[rows, cols] = blk[: min(tile[0], m - i * tile[0]), : min(tile[1], n - j * tile[1])]
    w = np.maximum(rng.rand(m, k).astype(np.float32), np.float32(EPS))
    h = np.maximum(rng.rand(k, n).astype(np.float32), np.float32(EPS))
    return x, w, h


def _ts_cases():
    """name -> (X, W, H, tile, pad) for the K5 checks; "main" is the
    solve's.  pad: the tile list padded to a multiple of it with zero tiles
    at block (0, 0), as the tiled solve pads it (1: not padded).  The long
    runs: 300 full 128^2 tiles in one column block (the H target's run of
    one output block crosses many pieces) and its transpose (the W
    target's): K5's counterpart of ``LONG_WALKS``."""
    m, n, k, t, occ, seed = TS_MAIN
    pallas = _fixed_tile_problem(
        512, 16, 640, (128, 128), [(0, 0), (1, 2), (3, 4), (2, 2), (0, 4)], 3, 0.6)
    tall = _fixed_tile_problem(38_400, 128, 128, (128, 128), [(i, 0) for i in range(300)], 7, 0.0)
    wide = _fixed_tile_problem(128, 128, 38_400, (128, 128), [(0, j) for j in range(300)], 8, 0.0)
    cases = {
        "pallas 512x640 K=16": (*pallas, (128, 128)),
        "padded 512x640 K=16": (*pallas, (128, 128), 64),
        "ragged 160x200 K=8": (*_fixed_tile_problem(
            160, 8, 200, (32, 32), [(0, 0), (1, 3), (2, 5), (4, 6), (3, 1), (0, 4)], 41, 0.5),
            (32, 32)),
        "96x160 tiles 288x480 K=24": (*_fixed_tile_problem(
            288, 24, 480, (96, 160), [(0, 0), (0, 2), (1, 1), (2, 1), (2, 2)], 5, 0.5), (96, 160)),
        "main": (*tile_problem(m, k, n, t, occ, seed), (t, t)),
        "K=300": (*tile_problem(384, 300, 512, 128, 0.5, 1), (128, 128)),
        "K=2048": (*tile_problem(256, 2048, 384, 128, 0.5, 2), (128, 128)),
        "long run 38400x128 K=128": (*tall, (128, 128)),
        "long run 128x38400 K=128": (*wide, (128, 128)),
    }
    return {label: case if len(case) == 5 else (*case, 1) for label, case in cases.items()}


class SweepCase(NamedTuple):
    w: torch.Tensor        # (Mp, K), padded with zeros
    h: torch.Tensor        # (K, Np)
    tiles: torch.Tensor    # (T, bm, bn)
    plans: dict            # target -> (perm, rb, cb) int32 on the card
    layouts: dict          # target -> SweepLayout on the card (the plain version's)
    empty: dict            # target -> output blocks with no tile


def _sweep_case(x, w, h, tile, pad=1):
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.sparse_tiled import _pad_tiles_np
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    tx = nt.tiles_from_dense(x, tile)
    tx = dataclasses.replace(tx, **dict(zip(("tiles", "rows", "cols"), _pad_tiles_np(
        np.asarray(tx.tiles), np.asarray(tx.rows), np.asarray(tx.cols), pad))))
    bm, bn = tile
    mb, nb = -(-x.shape[0] // bm), -(-x.shape[1] // bn)
    wp = np.zeros((mb * bm, w.shape[1]), np.float32)
    hp = np.zeros((h.shape[0], nb * bn), np.float32)
    wp[: w.shape[0]], hp[:, : h.shape[1]] = w, h
    plans, layouts, empty = {}, {}, {}
    for target, by, n_out in (("h", "col", nb), ("w", "row", mb)):
        plan = ts.sweep_plan(tx.rows, tx.cols, n_out, by)
        plans[target] = tuple(torch.from_numpy(a).cuda() for a in plan)
        layouts[target] = ts.sweep_layout(*plan, n_out, target, device="cuda")
        key = plan[2] if by == "col" else plan[1]
        empty[target] = sorted(set(key[plan[0] < 0].tolist()))
    return SweepCase(torch.from_numpy(wp).cuda(), torch.from_numpy(hp).cuda(),
                     torch.from_numpy(tx.tiles).cuda(), plans, layouts, empty)


def _z_biased_tiles(case, bm, bn):
    """f32 tiles on which a kernel that skips rounding Z to bf16 is off by a
    bias of one sign: X = b * (1 + 2**-10) * Y, b the tile's own values
    rounded to bf16 and Y = W H (bf16 W and H, in f64), so that the sound
    Z = X / Y rounds to b and the skipped one sits 2**-10 above it."""
    perm, rb, cb = (a.long() for a in case.plans["h"])
    real = perm >= 0
    perm, rb, cb = perm[real], rb[real], cb[real]
    k = case.w.shape[1]
    wb = case.w.to(torch.bfloat16).double().reshape(-1, bm, k)
    hb = case.h.to(torch.bfloat16).double().reshape(k, -1, bn).permute(1, 0, 2)
    y = torch.bmm(wb[rb], hb[cb])
    b = case.tiles[perm].to(torch.bfloat16).double()
    tiles = torch.empty_like(case.tiles)
    tiles[perm] = (b * (1 + 2.0 ** -10) * y).float()
    return tiles


def _k5_modes():
    """mode -> (Precision, W/H dtype, operands, limits, control Precision):
    operands "base", "exposed" (phase 3's W and H), "bf16_tiles", or
    "z_biased" (X built so that a skipped rounding of Z shows)."""
    from nmf_tpu_torch.utils.config import Precision

    f32 = Precision()
    bf16_state = Precision("bfloat16", "bfloat16", "float32")
    return {
        "float32": (f32, torch.float32, "base", None, None),
        "bfloat16": (Precision("bfloat16"), torch.float32, "exposed",
                     MODE_LIMITS["bfloat16"], f32),
        "float32_fast": (Precision("float32_fast"), torch.float32, "exposed",
                         MODE_LIMITS["float32_fast"], f32),
        "bf16_tiles": (Precision(x_dtype="bfloat16"), torch.float32, "bf16_tiles",
                       MODE_LIMITS["f32_gemm"], None),
        # W and H in bf16 are their own rounding: the control skips only Z's
        "bf16_state": (bf16_state, torch.bfloat16, "z_biased", MODE_LIMITS["bfloat16"],
                       dataclasses.replace(bf16_state, matmul_dtype="float32")),
    }


def _k5_err(out, ref, where):
    """(largest relative error, RMS relative error) over the entries where
    the plain version is not zero; where it is zero (blocks with no tile,
    padding) the kernel must read exactly zero too."""
    zero = ref == 0
    check(bool((out[zero] == 0).all()), f"{where}: nonzero where the plain version is zero")
    rel = ((out.double() - ref.double()).abs() / ref.double().abs())[~zero]
    return float(rel.max()), float(rel.square().mean().sqrt())


def _k5_bound(w, h, tiles, plan, target, prec):
    """K5's bound on these operands: two GEMMs of bm x bn x K a real plan
    entry (three bf16 passes each under split3), the tiles, W, H and the
    plan read once, the numerator written once."""
    bm, bn = tiles.shape[1:]
    k = w.shape[1]
    entries = int((plan[0] >= 0).sum())
    passes = 3 if prec.matmul_dtype == "float32_fast" else 1
    flops = passes * 4 * bm * bn * k * entries
    out_words = k * h.shape[1] if target == "h" else w.shape[0] * k
    nbytes = (tiles.numel() * tiles.element_size()
              + (w.numel() + h.numel()) * w.element_size()
              + 3 * 4 * plan[0].numel() + 4 * out_words)
    kind = "float32" if prec.matmul_dtype == "float32" else "bfloat16"
    return bound(flops, nbytes, kind)


def phase_tilesparse_kernels(card, out):
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    stats = out["kernels"]
    modes = _k5_modes()
    for label, (x, w, h, tile, pad) in _ts_cases().items():
        base = _sweep_case(x, w, h, tile, pad)
        bm, bn = tile
        for mode, (prec, state, operands, limits, control) in modes.items():
            wk, hk, tiles = base.w, base.h, base.tiles
            if operands == "exposed":
                rng = np.random.RandomState(sum(wk.shape) + hk.shape[1])
                wk, hk = _exposed(rng, tuple(wk.shape), mode), _exposed(rng, tuple(hk.shape), mode)
            elif operands == "bf16_tiles":
                tiles = tiles.to(torch.bfloat16)
            elif operands == "z_biased":
                tiles = _z_biased_tiles(base, bm, bn)
            wk, hk = wk.to(state), hk.to(state)
            for target, fn in (("h", ts.h_numerator), ("w", ts.w_numerator)):
                name = f"{target}_numerator"
                plan, layout = base.plans[target], base.layouts[target]
                where = f"{name} [{mode}] {label} tiles {bm}x{bn}"

                def kern(p=prec):
                    return fn(wk, hk, tiles, *plan, EPS, p)

                def plain():
                    return ts.sweep_plain(wk, hk, tiles, layout, EPS, prec, target)

                _, counts = sweep_counts(kern)
                ran = _mode_of_counts(counts[name], where)
                other = "w_numerator" if target == "h" else "h_numerator"
                check(ran == K5_MODE[mode] and not any(counts[other]),
                      f"{where}: K5 ran the {ran} instance ({counts}), expected {K5_MODE[mode]}")
                res, ref = _run_pair(lambda *_: kern(), lambda *_: plain(), wk, hk, tiles, where)
                n_out = res.shape[1] // bn if target == "h" else res.shape[0] // bm
                blocks = (res.reshape(-1, n_out, bn).transpose(0, 1) if target == "h"
                          else res.reshape(n_out, bm, -1))
                check(all(bool((blocks[b] == 0).all()) for b in base.empty[target]),
                      f"{where}: a block with no tile is not exactly zero")
                err, spread = _k5_err(res, ref, where)
                max_abs = float((res - ref).abs().max())
                if limits is None:   # float32: phase 2's tolerance
                    rtol, atol, _ = F32_TOL
                    worst = float(((res - ref).abs() - rtol * ref.abs()).max())
                    check(worst <= atol, f"{where}: worst excess over rtol {rtol}: {worst}")
                    what = f"max abs err {max_abs}, worst excess over rtol {rtol}: {worst}"
                else:
                    max_limit, spread_limit, _ = limits
                    check(max_limit is None or err <= max_limit,
                          f"{where}: max rel err {err} (limit {max_limit})")
                    check(spread_limit is None or spread <= spread_limit,
                          f"{where}: rms rel err {spread} (limit {spread_limit})")
                    what = (f"max rel err {err} (limit {max_limit}), rms rel err {spread} "
                            f"(limit {spread_limit})")
                st = stats[name]
                ms = st["modes"].setdefault(mode, {"max_abs_err": 0.0, "max_rel_err": 0.0,
                                                   "err": 0.0, "limit": limits and limits[1],
                                                   "impl": IMPL.get(ran, "simt")})
                ms["max_abs_err"] = max(ms["max_abs_err"], max_abs)
                ms["max_rel_err"] = max(ms["max_rel_err"], err)
                ms["err"] = max(ms["err"], spread)
                if mode == "float32":
                    st["max_abs_err"] = max(st["max_abs_err"], max_abs)
                if control is not None:
                    _, c_spread = _k5_err(kern(control), ref, where)
                    check(c_spread > limits[1], f"{where}: the control ({control.matmul_dtype} "
                          f"GEMMs) reads {c_spread}, within the limit {limits[1]}")
                    ms["control_min"] = min(ms.get("control_min", c_spread), c_spread)
                    what += f"; control ({control.matmul_dtype} GEMMs) {c_spread}"
                if label == "main":   # the solve's shape, timed
                    kms, pms = timed_pair(kern, plain)
                    b_ms, b_by = _k5_bound(wk, hk, tiles, plan, target, prec)
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by)
                    if mode == "float32":
                        st.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                                  impl=IMPL.get(ran, "simt"))
                    what = (f"kernel {kms} ms, plain {pms} ms, bound {b_ms} ms ({b_by}); "
                            + what)
                print(f"[{card}] {where}: {what}, bitwise-repeatable, instance {ran}")


def _ts_solve(x, w, h, cfg, **kw):
    """(result, host seconds) of one tile-sparse solve on the card."""
    import nmf_tpu_torch as nt

    t0 = time.perf_counter()
    res = nt.solve_sparse_tiled(x, w, h, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _counted(fn):
    """(fn(), K5 launches, K5 plain calls, K1-K3 launches) with every count
    set to 0 just before."""
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    fused_mu.reset_counts()
    ts.reset_counts()
    res = fn()
    return res, dict(ts.LAUNCHES), dict(ts.PLAIN_CALLS), dict(fused_mu.LAUNCHES)


def _check_history(res, where):
    hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
    check(int(res.iterations) == TS_ITERS and hist.shape == (TS_ITERS // 25,),
          f"{where}: {int(res.iterations)} iterations, {hist.shape[0]} checks")
    check(bool(np.all(np.isfinite(hist)) and np.all(np.diff(hist) < 0)),
          f"{where}: costs not finite and decreasing: {hist}")
    return hist


def phase_tilesparse_solves(card, out):
    import nmf_tpu_torch as nt

    m, n, k, t, occ, seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    print(f"[{card}] tile-sparse X {m}x{n}, {t}x{t} tiles: {tx.tiles.shape[0]} occupied "
          f"(occupancy {tx.occupancy()}), K={k}, {TS_ITERS} iterations")
    eps = np.float32(EPS)
    want = {"h_numerator": TS_ITERS, "w_numerator": TS_ITERS}
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 1e-3), ("float32_fast", 1e-4)):
        cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision(dtype),
                             backend="pallas")
        # warm both paths once (the library, the allocator, cuBLAS)
        for backend in ("pallas", "jnp"):
            _ts_solve(tx, w, h, dataclasses.replace(cfg, backend=backend, max_iter=2))
        ((res, secs), per_mode), launches, plain_calls, dense = _counted(
            lambda: sweep_counts(lambda: _ts_solve(tx, w, h, cfg)))
        where = f"tiled solve [{dtype}]"
        check(launches == want, f"{where}: K5 launches {launches}, expected {want}")
        mode = K5_MODE[dtype]
        check(all(counts == [TS_ITERS if m == mode else 0 for m in MODES]
                  for counts in per_mode.values()),
              f"{where}: K5 pass-1 launches per Mode {per_mode}, expected {TS_ITERS} {mode}")
        check(not any(plain_calls.values()) and not any(dense.values()),
              f"{where}: plain calls {plain_calls}, K1-K3 launches {dense}")
        out["launches"][f"tiled {dtype}"] = launches
        hist = _check_history(res, where)
        res2, secs2 = _ts_solve(tx, w, h, cfg)
        for f in ("w", "h"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f.upper()} differs on a rerun")
        cost = float(res.cost)
        plain, p_secs = _ts_solve(tx, w, h, dataclasses.replace(cfg, backend="jnp"))
        rel = abs(cost - float(plain.cost)) / abs(float(plain.cost))
        check(rel <= limit, f"{where}: cost {cost} vs the jnp tiled solve {float(plain.cost)}: "
              f"rel {rel} (limit {limit})")
        line = (f"[{card}] {where}: K5 {launches} ({mode} instance), cost {cost}, history {hist.tolist()}, "
                f"byte-identical on rerun; {TS_ITERS / secs} and {TS_ITERS / secs2} it/s through "
                f"K5, {TS_ITERS / p_secs} it/s plain sweep (backend='jnp', cost {float(plain.cost)}, "
                f"rel {rel}, limit {limit})")
        out["tiled"][dtype] = {"k5_its": [TS_ITERS / secs, TS_ITERS / secs2],
                               "plain_its": TS_ITERS / p_secs, "rel_vs_plain": rel,
                               "impl": IMPL.get(mode, "simt")}
        if dtype == "float32":
            # the exact-zero contract: the dense solve through K1-K3 with
            # clamp_inputs=False on clamped factors
            nt.solve(x, np.maximum(w, eps), np.maximum(h, eps),
                     dataclasses.replace(cfg, max_iter=2), clamp_inputs=False, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (dres, _, _, dense) = _counted(lambda: nt.solve(
                x, np.maximum(w, eps), np.maximum(h, eps), cfg, clamp_inputs=False,
                device="cuda"))
            torch.cuda.synchronize()
            d_secs = time.perf_counter() - t0
            check(dense == _launches(update_h=TS_ITERS, update_w=TS_ITERS, kl_cost=TS_ITERS // 25),
                  f"dense solve: K1-K3 launches {dense}")
            d_rel = abs(cost - float(dres.cost)) / abs(float(dres.cost))
            check(d_rel <= 1e-4, f"{where}: cost {cost} vs the dense clamp_inputs=False solve "
                  f"{float(dres.cost)}: rel {d_rel}")
            line += (f"; dense solve through K1-K3 {TS_ITERS / d_secs} it/s (host clock incl. "
                     f"the {x.nbytes / 1e6} MB X upload), cost {float(dres.cost)}, rel {d_rel} "
                     "(limit 1e-4)")
            out["tiled"]["dense_its"] = TS_ITERS / d_secs
        print(line)

    # the RETUNE cell's rank, bfloat16 (the generator draws X before W and
    # H, so X and its tiles are the same)
    _, wk, hk = tile_problem(m, 256, n, t, occ, seed)
    cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision("bfloat16"),
                         backend="pallas")
    _ts_solve(tx, wk, hk, dataclasses.replace(cfg, max_iter=2))
    (res, secs), launches, plain_calls, _ = _counted(lambda: _ts_solve(tx, wk, hk, cfg))
    check(launches == want and not any(plain_calls.values()), f"K=256: K5 launches {launches}")
    hist = _check_history(res, "tiled solve [bfloat16] K=256")
    out["tiled"]["bfloat16 K=256"] = TS_ITERS / secs
    print(f"[{card}] tiled solve [bfloat16] K=256: K5 {launches}, cost {float(res.cost)}, "
          f"{TS_ITERS / secs} it/s (host clock incl. the tile upload)")
    # int8 tiles: per-tile uint8 codes take the plain sweep by rule
    cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision(x_dtype="int8"))
    (res, secs), launches, plain_calls, dense = _counted(lambda: _ts_solve(tx, w, h, cfg))
    check(not any(launches.values()) and not any(plain_calls.values()) and not any(dense.values()),
          f"int8 tiles: launches {launches}, plain calls {plain_calls}, K1-K3 {dense}")
    hist = _check_history(res, "tiled solve [int8 tiles]")
    print(f"[{card}] tiled solve [int8 tiles]: plain sweep by rule (0 launches), cost "
          f"{float(res.cost)}, history {hist.tolist()}, {TS_ITERS / secs} it/s")


def phase_tilesparse(card, out):
    print(f"[{card}] phase 8: tile-sparse K5 vs plain torch on the card, and the tiled solve")
    phase_tilesparse_kernels(card, out)
    phase_tilesparse_solves(card, out)


# Phase 9: the out-of-core streamed solve at an hour of audio, the ISMIR
# spectrogram (bench.py:59, BASELINE config 2: M=1025, K=32) over 172
# frames/s x 3600 s, rounded up to a multiple of 128 (nmf_tpu/parallel/
# mesh.py:24-26): X is 2.54 GB of f32, streamed in pick_block_n's 10 blocks.
OOC_SHAPE = (1025, 619_264, 32)        # M, N, K
OOC_BLOCK = 65_408                     # pick_block_n(1025, 619264): 256 MiB of f32
OOC_ITERS, OOC_CHECK = 10, 5
OOC_FACTOR_RTOL = 1e-4                 # streamed vs in-memory factors (max rel)
# the JAX package's out-of-core cell (benchmarks/run_all.py:578-593,
# bench.py:901-903): m, n, k, block_n
OOC_CLI = (2048, 8192, 128, 1024)
# phase 9a's mode -> the streamed run whose launches it reports
OOC_RUNS = {"float32": "oocore float32", "x_bfloat16": "oocore bfloat16", "x_int8": "oocore int8"}
# the modes whose streamed cost pass is a K3 call of its own (f32 GEMMs on
# the state and X as stored; the GEMM policies' cost passes are float32's)
OOC_COST_MODES = ("float32", "x_bfloat16", "x_int8", "bf16_state")


def _num_modes():
    """mode -> ModeCheck of K1/K2's numerator_only: phase 3's modes, and bf16
    state with f32 X built so that a skipped rounding of Z shows (the
    numerator is f32, so bf16 state has the ``bfloat16`` limits, as K5's;
    under ``float32_fast`` its own)."""
    from nmf_tpu_torch.utils.config import Precision

    f32 = Precision()
    bf16_state = Precision("bfloat16", "bfloat16", "float32")
    modes = {"float32": ModeCheck(f32, torch.float32, "f32", MODE_LIMITS["f32_gemm"])}
    modes.update((mode, spec) for mode, spec in _modes().items() if spec.state == torch.float32)
    modes["bf16_state"] = ModeCheck(bf16_state, torch.bfloat16, "z_biased",
                                    MODE_LIMITS["bfloat16"],
                                    dataclasses.replace(bf16_state, matmul_dtype="float32"),
                                    ("update_h", "update_w"))
    modes["float32_fast_bf16_state"] = _modes()["float32_fast_bf16_state"]._replace(
        limits=MODE_LIMITS["float32_fast"])
    return modes


def _num_operands(m, n, k, mode, spec):
    """Phase 3's operands; for bf16 state X = b (1 + 2**-10) W H with b
    bf16-exact and W H in f64 from the bf16 factors, so that the sound Z
    rounds to b and a Z left unrounded sits 2**-10 above it."""
    if spec.xform != "z_biased":
        return _mode_operands(m, n, k, mode, spec)
    w, h, x = _operands(m, n, k)
    w, h = w.to(torch.bfloat16), h.to(torch.bfloat16)
    y = w.double() @ h.double()
    x = (x.to(torch.bfloat16).double() * (1 + 2.0 ** -10) * y).float()
    return w, h, x


def _num_pairs(prec):
    """name -> (numerator_only kernel, its plain version) under ``prec``."""
    from nmf_tpu_torch.ops import mu
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.quant import dequantize

    def dense(x):
        return dequantize(*x) if isinstance(x, tuple) else x

    return {
        "update_h": (lambda w, h, x: fused_mu.update_h_fused(w, h, x, precision=prec,
                                                             numerator_only=True),
                     lambda w, h, x: mu.numerator_h(w, h, dense(x), precision=prec)),
        "update_w": (lambda w, h, x: fused_mu.update_w_fused(w, h, x, precision=prec,
                                                             numerator_only=True),
                     lambda w, h, x: mu.numerator_w(w, h, dense(x), precision=prec)),
    }


def _num_bound(name, w, h, x, prec):
    """A numerator's bound: the full update's flops and bytes, the output
    written in f32 (no epilogue: W and H are read for the GEMMs alone)."""
    m, k = w.shape
    n = h.shape[1]
    split3 = prec.matmul_dtype == "float32_fast"
    kind = "float32" if prec.matmul_dtype == "float32" else "bfloat16"
    flops = (3 if split3 else 1) * 2 * 2 * m * n * k
    x_bytes = sum(t.numel() * t.element_size() for t in (x if isinstance(x, tuple) else (x,)))
    out_words = k * n if name == "update_h" else m * k
    return bound(flops, x_bytes + (w.numel() + h.numel()) * w.element_size() + 4 * out_words, kind)


def _epilogue_of(name, w, h, num):
    """The full update from a numerator, in the kernels' order
    ``base * acc / denom`` (csrc/fused_mu.cu finalize), in the state dtype."""
    from nmf_tpu_torch.ops.elementwise import eps_clamp

    if name == "update_h":
        return (h.float() * num / eps_clamp(torch.sum(w, 0, dtype=torch.float32), EPS)[:, None]).to(h.dtype)
    return (w.float() * num / eps_clamp(torch.sum(h, 1, dtype=torch.float32), EPS)[None, :]).to(w.dtype)


def phase_numerators(card, out):
    print(f"[{card}] phase 9a: numerator_only of K1/K2 and the streamed K3 vs plain torch on "
          "the card, every mode")
    from nmf_tpu_torch.ops.kernels import fused_mu

    stats = out["kernels"]
    m_o, n_o, k_o = OOC_SHAPE
    block = (m_o, OOC_BLOCK, k_o)
    shapes = [*MODE_SHAPES, block, (m_o, n_o - (n_o // OOC_BLOCK) * OOC_BLOCK, k_o)]
    for mode, spec in _num_modes().items():
        pairs, controls = _num_pairs(spec.prec), (_num_pairs(spec.control) if spec.control else {})
        updates = _pairs(spec.prec)
        # the streamed cost pass: K3 with f32 GEMMs on the state as stored
        cost_prec = dataclasses.replace(spec.prec, matmul_dtype="float32")
        cost_pair = _pairs(cost_prec)["kl_cost"] if mode in OOC_COST_MODES else None
        max_limit, spread_limit, _ = spec.limits
        # the full update: bf16 state rounds its output (phase 3's limits)
        full_max, full_spread, _ = (MODE_LIMITS["bf16_state"] if spec.state == torch.bfloat16
                                    else spec.limits)
        for m, n, k in shapes:
            w, h, x = _num_operands(m, n, k, mode, spec)
            for name, (kern, plain) in pairs.items():
                where = _where(f"{name} numerator_only", w, h, f"[{mode}] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                check(res.dtype == torch.float32, f"{where}: dtype {res.dtype}")
                check(tuple(res.shape) == ((k, n) if name == "update_h" else (m, k)),
                      f"{where}: shape {tuple(res.shape)}")
                err, spread, _ = _mode_err(res, ref)
                check(max_limit is None or err <= max_limit,
                      f"{where}: max rel err {err} (limit {max_limit})")
                check(spread_limit is None or spread <= spread_limit,
                      f"{where}: rms rel err {spread} (limit {spread_limit})")
                what = (f"max rel err {err} (limit {max_limit}), rms rel err {spread} "
                        f"(limit {spread_limit})")
                # the full update is this numerator through the epilogue, bit
                # for bit, and within the mode's limits of its plain version
                upd, upd_plain = (f(w, h, x) for f in updates[name])
                check(torch.equal(_bits(upd), _bits(_epilogue_of(name, w, h, res))),
                      f"{where}: the full update is not base * numerator / denom bitwise")
                f_err, f_spread, f_ulps = _mode_err(upd, upd_plain)
                check(f_ulps <= 1 and (full_max is None or f_err <= full_max)
                      and (full_spread is None or f_spread <= full_spread),
                      f"{where}: the full update vs plain: max rel err {f_err} (limit {full_max}), "
                      f"spread {f_spread} (limit {full_spread}), {f_ulps} bf16 ulps")
                key = "numerator_only" if mode == "float32" else f"numerator_only {mode}"
                ms = stats[name]["modes"].setdefault(
                    key, {"max_abs_err": 0.0, "max_rel_err": 0.0, "err": 0.0, "limit": spread_limit,
                          "launches_of": (OOC_RUNS.get(mode), f"{name}_numerator")})
                ms["max_abs_err"] = max(ms["max_abs_err"], float((res - ref).abs().max()))
                ms["max_rel_err"] = max(ms["max_rel_err"], err)
                ms["err"] = max(ms["err"], spread)
                if name in spec.controlled:
                    _, c_spread, _ = _mode_err(controls[name][0](w, h, x), ref)
                    check(c_spread > spread_limit, f"{where}: the control "
                          f"({spec.control.matmul_dtype} GEMMs) reads {c_spread}, within "
                          f"the limit {spread_limit}")
                    ms["control_min"] = min(ms.get("control_min", c_spread), c_spread)
                    what += f"; control ({spec.control.matmul_dtype} GEMMs) {c_spread}"
                if (m, n, k) == block:   # the streamed block, timed
                    kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
                    b_ms, b_by = _num_bound(name, w, h, x, spec.prec)
                    impl = _check_impls(lambda: [f(w, h, x) for f, _ in pairs.values()],
                                        spec.prec, where)[name]
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by, impl=impl)
                    what = (f"kernel {kms} ms ({impl}), plain {pms} ms, bound {b_ms} ms ({b_by}); "
                            + what)
                print(f"[{card}] {where}: {what}, bitwise-repeatable, epilogue bitwise, full "
                      f"update vs plain max rel {f_err} spread {f_spread}")
            if cost_pair:
                kern, plain = cost_pair
                where = _where("kl_cost streamed", w, h, f"[{mode}] ")
                res, ref = _run_pair(kern, plain, w, h, x, where)
                err = _mode_err(res, ref)[0]
                cost_limit = MODE_LIMITS["f32_gemm"][2]
                check(err <= cost_limit, f"{where}: rel err {err} (limit {cost_limit})")
                key = "streamed" if mode == "float32" else f"streamed {mode}"
                ms = stats["kl_cost"]["modes"].setdefault(
                    key, {"max_abs_err": 0.0, "max_rel_err": 0.0, "err": 0.0, "limit": cost_limit,
                          "launches_of": (OOC_RUNS.get(mode), "kl_cost")})
                ms["max_abs_err"] = max(ms["max_abs_err"], abs(float(res) - float(ref)))
                ms["max_rel_err"] = ms["err"] = max(ms["err"], err)
                inst = _check_kl_mode(kern, w, h, x, cost_prec, where)
                what = f"rel err {err} (limit {cost_limit}), {inst}"
                if (m, n, k) == block:
                    kms, pms = timed_pair(lambda: kern(w, h, x), lambda: plain(w, h, x))
                    b_ms, b_by = _mu_bound("kl_cost", w, h, x, cost_prec)
                    ms.update(ms=kms, plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                              impl=_kl_impl(inst), instance=inst)
                    what = f"kernel {kms} ms, plain {pms} ms, bound {b_ms} ms ({b_by}); " + what
                print(f"[{card}] {where}: {what}, bitwise-repeatable")
            del w, h, x
    # above the rank ceiling the numerator takes the plain ops by rule
    k = fused_mu.MAX_FUSED_K + 8
    w, h, x = _operands(64, 96, k)
    for name, (kern, _) in _num_pairs(_num_modes()["float32"].prec).items():
        fused_mu.reset_counts()
        res = kern(w, h, x)
        check(res.dtype == torch.float32 and fused_mu.PLAIN_CALLS[f"{name}_numerator"] == 1
              and not any(fused_mu.LAUNCHES.values()),
              f"{name} numerator_only K={k}: did not take the plain ops by rule")
    print(f"[{card}] numerator_only K={k} > MAX_FUSED_K: plain ops by the rank rule, no launch")


def h2d_rate(nbytes) -> float:
    """Bytes/s of one pinned host-to-device copy of ``nbytes``: CUDA events,
    the median of 5 copies after a warm one."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    times = []
    for i in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b) / 1e3)
    return nbytes / statistics.median(times)


def _union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for t0, t1 in sorted(intervals):
        if t1 > end:
            total += t1 - max(t0, end)
            end = t1
    return total


def _device_shares(trace_path):
    """Seconds of a chrome trace's device events: kernels, H2D copies, busy
    (the union of every kernel, copy and memset interval) and the overlap
    of kernels with H2D copies (both running at once)."""
    events = json.loads(pathlib.Path(trace_path).read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(any(e["cat"] == "kernel" for e in dev), "the profiler recorded no kernel")
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in dev if e["cat"] == "kernel"]
    h2d = [(e["ts"], e["ts"] + e["dur"]) for e in dev
           if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    overlap = _union(kern) + _union(h2d) - _union(kern + h2d)
    return {"kernels": sum(t1 - t0 for t0, t1 in kern) / 1e6,
            "h2d": sum(t1 - t0 for t0, t1 in h2d) / 1e6,
            "busy": busy / 1e6, "overlap": overlap / 1e6}


def _host_timed(fn):
    """(fn's value, host seconds of each ``_BlockStream._put`` and ``_fill``
    call while it ran): ``_fill`` is a block's gather (and cast or
    quantization) into its pinned buffer, ``_put`` that plus the wait for
    the buffer's last copy and the copy's issue."""
    from nmf_tpu_torch.models import streaming

    cls = streaming._BlockStream
    times = {"_put": [], "_fill": []}
    originals = {name: getattr(cls, name) for name in times}

    def timed(name, f):
        def call(self, *args):
            t0 = time.perf_counter()
            try:
                return f(self, *args)
            finally:
                times[name].append(time.perf_counter() - t0)
        return call

    for name, f in originals.items():
        setattr(cls, name, timed(name, f))
    try:
        return fn(), times
    finally:
        for name, f in originals.items():
            setattr(cls, name, f)


def _ooc_solve(x, w, h, cfg, **kw):
    """(result, host seconds, K1-K3 launches, plain calls) of one streamed
    solve on the card, the counts set to 0 just before."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    fused_mu.reset_counts()
    t0 = time.perf_counter()
    res = nt.solve_out_of_core(x, w, h, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(fused_mu.LAUNCHES), dict(fused_mu.PLAIN_CALLS)


def _max_rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs()).max())


def phase_oocore_solves(card, out, seed):
    import gc

    import nmf_tpu_torch as nt

    m, n, k = OOC_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    xd = torch.rand((m, n), generator=g, device="cuda").clamp_min_(EPS)
    w = torch.rand((m, k), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    h = torch.rand((k, n), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    x = xd.cpu().numpy()
    del xd
    bn = nt.pick_block_n(m, n)
    blocks = -(-n // bn)
    check(bn == OOC_BLOCK and blocks == 10, f"pick_block_n gave {bn} ({blocks} blocks)")
    cfg = nt.SolveConfig(max_iter=OOC_ITERS, check_every=OOC_CHECK, backend="pallas")
    passes = -(-OOC_ITERS // OOC_CHECK)
    streams = OOC_ITERS + passes
    print(f"[{card}] phase 9b: streamed solve {m}x{n}, K={k}: X {x.nbytes / 1e9} GB f32 in "
          f"{blocks} blocks of {bn} (last {n - (blocks - 1) * bn}), {OOC_ITERS} iterations, "
          f"cost passes every {OOC_CHECK}: {streams} streams of X")
    want = _launches(update_h=blocks * OOC_ITERS, update_w_numerator=blocks * OOC_ITERS,
                     kl_cost=blocks * passes)
    results = {}
    for xdt in ("float32", "bfloat16", "int8"):
        c = dataclasses.replace(cfg, precision=nt.Precision(x_dtype=xdt))
        # the in-memory solve on the same X first, freed before the
        # streamed run's memory is read
        t0 = time.perf_counter()
        mem = nt.solve(x, w, h, c, device="cuda")
        torch.cuda.synchronize()
        mem_secs = time.perf_counter() - t0
        mem_w, mem_h, mem_cost = mem.w.cpu(), mem.h.cpu(), float(mem.cost)
        del mem
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, secs, launches, plain_calls = _ooc_solve(x, w, h, c)
        peak = torch.cuda.max_memory_allocated()
        where = f"streamed [{xdt} X]"
        check(launches == want, f"{where}: launches {launches}, expected {want}")
        check(not any(plain_calls.values()), f"{where}: plain calls {plain_calls}")
        hist = res.cost_history.numpy()[: int(res.num_checks)]
        check(int(res.iterations) == OOC_ITERS and hist.shape == (passes,)
              and bool(np.all(np.isfinite(hist))) and bool(np.all(np.diff(hist) < 0)),
              f"{where}: {int(res.iterations)} iterations, history {hist}")
        check(tuple(res.w.shape) == (m, k) and tuple(res.h.shape) == (k, n)
              and bool(torch.isfinite(res.w).all()) and bool(torch.isfinite(res.h).all()),
              f"{where}: factors not finite of the expected shapes")
        cost = float(res.cost)
        rel = abs(cost - mem_cost) / abs(mem_cost)
        check(rel <= 1e-5, f"{where}: cost {cost} vs the in-memory solve {mem_cost}: rel {rel}")
        fw, fh = _max_rel(res.w.cpu(), mem_w), _max_rel(res.h.cpu(), mem_h)
        check(max(fw, fh) <= OOC_FACTOR_RTOL, f"{where}: factors vs the in-memory solve: "
              f"max rel W {fw}, H {fh} (limit {OOC_FACTOR_RTOL})")
        out["launches"][f"oocore {xdt}"] = launches
        line = (f"[{card}] {where}: launches {launches}, cost {cost}, history {hist.tolist()}, "
                f"{OOC_ITERS / secs} it/s ({secs} s, first run); in-memory solve cost "
                f"{mem_cost} (rel {rel}, limit 1e-5), factors max rel W {fw} H {fh} (limit "
                f"{OOC_FACTOR_RTOL}), {OOC_ITERS / mem_secs} it/s incl. its upload; peak device "
                f"memory {peak / 1e9} GB (before the solve {base / 1e9} GB)")
        results[xdt] = {"its": OOC_ITERS / secs, "cost": cost, "rel_vs_memory": rel,
                        "factor_rel_vs_memory": max(fw, fh), "peak_gb": peak / 1e9}
        if xdt == "float32":
            wire = 4 * m * bn
            parts = {"W": 4 * m * k, "H": 4 * k * n, "two blocks": 2 * wire, "a1": 4 * m * k}
            line += f" = {', '.join(f'{p} {b / 1e9}' for p, b in parts.items())} GB + scratch"
            check(peak < x.nbytes / 3, f"{where}: peak device memory {peak} B not under a "
                  f"third of X ({x.nbytes} B)")
            first = res
        print(line)
        if xdt != "float32":
            continue
        # reruns: timed (with host timers around each block's staging),
        # then profiled; both byte-identical to the first
        rate0 = h2d_rate(4 * m * bn)
        (res2, secs2, _, _), host = _host_timed(lambda: _ooc_solve(x, w, h, c))
        rate1 = h2d_rate(4 * m * bn)
        check(len(host["_fill"]) == blocks * streams, f"{where}: {len(host['_fill'])} fills")
        fill_s = sum(host["_fill"])
        wait_s = sum(host["_put"]) - fill_s
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res3, secs3, _, _ = _ooc_solve(x, w, h, c)
        for r, label in ((res2, "timed"), (res3, "profiled")):
            for f in ("w", "h"):
                check(torch.equal(_bits(getattr(r, f)), _bits(getattr(first, f))),
                      f"{where}: {f.upper()} of the {label} rerun differs")
        rate = statistics.median([rate0, rate1])
        roof = streams * x.nbytes / rate
        with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            dev = {key: v / secs3 for key, v in _device_shares(trace).items()}
        fills_ms = sorted(1e3 * t for t in host["_fill"])
        results["time"] = {
            "its_timed": OOC_ITERS / secs2, "its_profiled": OOC_ITERS / secs3,
            "h2d_gbps": [rate0 / 1e9, rate1 / 1e9], "roofline_s": roof,
            "roofline_fraction": roof / secs2, "fill_share": fill_s / secs2,
            "put_wait_share": wait_s / secs2, "fill_ms_median": statistics.median(fills_ms),
            "fill_ms_max": fills_ms[-1], "kernel_share": dev["kernels"],
            "h2d_share": dev["h2d"], "overlap_share": dev["overlap"],
            "idle_share": 1 - dev["busy"],
        }
        print(f"[{card}] {where}: reruns byte-identical; timed {OOC_ITERS / secs2} it/s "
              f"({secs2} s for {streams} streams), profiled {OOC_ITERS / secs3} it/s; H2D "
              f"{rate0 / 1e9} / {rate1 / 1e9} GB/s (pinned, {4 * m * bn} B, before / after); "
              f"H2D roofline {roof} s = {roof / secs2} of the timed run reached; host over "
              f"the timed run: block fills (gather into pinned memory) {fill_s / secs2} of the "
              f"wall, {len(fills_ms)} fills, median {statistics.median(fills_ms)} ms, max "
              f"{fills_ms[-1]} ms; waits for a pinned buffer's copy and copy issue "
              f"{wait_s / secs2}; device over the profiled run: kernels {dev['kernels']}, H2D "
              f"copies {dev['h2d']}, kernels and copies at once {dev['overlap']}, busy "
              f"{dev['busy']}, idle {1 - dev['busy']}")
        # the plain ops (backend="jnp") on the same stream
        jnp, j_secs, j_launch, _ = _ooc_solve(x, w, h, dataclasses.replace(c, backend="jnp"))
        check(not any(j_launch.values()), f"{where} jnp: launches {j_launch}")
        j_rel = abs(cost - float(jnp.cost)) / abs(float(jnp.cost))
        check(j_rel <= 1e-5, f"{where}: cost {cost} vs the jnp streamed solve "
              f"{float(jnp.cost)}: rel {j_rel}")
        results["jnp"] = {"its": OOC_ITERS / j_secs, "rel": j_rel}
        print(f"[{card}] {where} backend='jnp': cost {float(jnp.cost)} (rel {j_rel}, limit "
              f"1e-5), {OOC_ITERS / j_secs} it/s")
        del res2, res3, jnp
    out["oocore"] = results


def phase_oocore_cli(card, tmp, out):
    import nmf_tpu_torch as nt

    m, n, k, bn = OOC_CLI
    print(f"[{card}] phase 9c: run --out-of-core --block-n {bn} at {m}x{n}, K={k}, through the CLI")
    rng = np.random.RandomState(0)
    x = np.maximum(rng.rand(m, n).astype(np.float32), np.float32(EPS))
    w, h = rng.rand(m, k).astype(np.float32), rng.rand(k, n).astype(np.float32)
    for name, a in (("X", x), ("W", w), ("H", h)):
        nt.write_matrix(a, os.path.join(tmp, f"ooc_{name}.bin"))
    t0 = time.perf_counter()
    _cli(["run", "ooc_X.bin", "ooc_W.bin", "ooc_H.bin", "-o", "ooc_Wout.bin", "ooc_Hout.bin",
          "--out-of-core", "--block-n", str(bn), "--jsonl", "ooc.jsonl", "-q"], tmp)
    wall = time.perf_counter() - t0
    rec = json.loads(pathlib.Path(tmp, "ooc.jsonl").read_text().splitlines()[-1])
    cfg = nt.reference_preset()
    res, secs, launches, _ = _ooc_solve(nt.BinColumnSource(os.path.join(tmp, "ooc_X.bin")),
                                        w, h, cfg, block_n=bn)
    blocks = n // bn
    check(launches == _launches(update_h=200 * blocks, update_w_numerator=200 * blocks,
                                kl_cost=8 * blocks), f"CLI out-of-core in-process: launches {launches}")
    for f, t in (("W", res.w), ("H", res.h)):
        got = nt.read_matrix(os.path.join(tmp, f"ooc_{f}out.bin"))
        check(got.tobytes() == t.cpu().numpy().tobytes(),
              f"CLI --out-of-core {f} file differs from the in-process solve_out_of_core")
    mem = nt.solve(x, w, h, cfg, device="cuda")
    rel = abs(rec["final_cost"] - float(mem.cost)) / abs(float(mem.cost))
    check(rel <= 1e-5, f"CLI --out-of-core cost {rec['final_cost']} vs in-memory {float(mem.cost)}")
    out["oocore"]["cli"] = {"its": rec["iters_per_sec"], "rel_vs_memory": rel}
    print(f"[{card}] CLI --out-of-core: {rec['iterations']} iterations, final cost "
          f"{rec['final_cost']} (in-memory solve {float(mem.cost)}, rel {rel}, limit 1e-5), "
          f"{rec['iters_per_sec']} it/s, process wall {wall} s; files byte-identical to the "
          f"in-process solve_out_of_core ({200 / secs} it/s, launches {launches})")


def phase_oocore(card, tmp, out, seed):
    phase_numerators(card, out)
    phase_oocore_solves(card, out, seed)
    phase_oocore_cli(card, tmp, out)


# Phase 10: the accelerated loop (accelerate=True) on each solve: the
# reference shape, the flagship, the tile-sparse solve and the streamed one.
ACCEL_ITERS = 200
ACCEL_FLAGSHIP = (10240, 10240, 256, 50)   # M, N, K, iterations (phase 7's)


def _calls(fn, module, names):
    """(fn(), {name: calls}) with ``module``'s functions ``names`` wrapped to
    count their calls: the plain path's step and cost (``backend="jnp"``),
    which no kernel count sees."""
    calls = dict.fromkeys(names, 0)
    originals = {name: getattr(module, name) for name in names}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    for name in names:
        setattr(module, name, counting(name))
    try:
        return fn(), calls
    finally:
        for name, f in originals.items():
            setattr(module, name, f)


def _rejects(steps, costs, res, chunk, where, blocks=1, seeded=True):
    """Rejected check blocks from a solve's step and cost counts, which must
    agree: steps = blocks x (iterations + chunk x rejects), costs = blocks x
    (seed + checks + rejects)."""
    it, checks = int(res.iterations), int(res.num_checks)
    extra = steps - blocks * it
    check(extra >= 0 and extra % (blocks * chunk) == 0,
          f"{where}: {steps} steps for {it} iterations in blocks of {chunk}")
    rejects = extra // (blocks * chunk)
    check(costs == blocks * (int(seeded) + checks + rejects),
          f"{where}: {costs} costs for {checks} checks and {rejects} rejects")
    return rejects


def _timed(fn):
    """(fn(), host seconds) of work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _accel_history(res, where, checks):
    hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
    check(hist.shape == (checks,) and bool(np.all(np.isfinite(hist)))
          and bool(np.all(np.diff(hist) <= 0)),
          f"{where}: history {hist} not {checks} finite non-increasing checks")
    return hist


def _same_bits(a, b, where):
    for f in ("w", "h", "cost_history", "momentum"):
        check(torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f))),
              f"{where}: {f} differs on a rerun")


def _counted_accel(x, w, h, cfg, where, **kw):
    """(result, seconds, launches, rejects) of one accelerated solve through
    K1-K3, the counts set to 0 just before; the launches match the rejects
    and no call took the plain ops."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    fused_mu.reset_counts()
    res, secs = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda", **kw))
    launches = dict(fused_mu.LAUNCHES)
    chunk = cfg.check_every
    seeded = "initial_cost" not in kw
    rejects = _rejects(launches["update_h"], launches["kl_cost"], res, chunk, where,
                       seeded=seeded)
    steps = int(res.iterations) + chunk * rejects
    want = _launches(update_h=steps, update_w=steps,
                     kl_cost=int(seeded) + int(res.num_checks) + rejects)
    check(launches == want and not any(fused_mu.PLAIN_CALLS.values()),
          f"{where}: launches {launches}, plain calls {fused_mu.PLAIN_CALLS}, expected {want}")
    return res, secs, launches, rejects


def _plain_accel(x, w, h, cfg, where, **kw):
    """(result, seconds, rejects) of the same accelerated solve on the plain
    ops (``backend="jnp"``), its rejects read from its step and cost calls."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import solver

    (res, secs), calls = _calls(
        lambda: _timed(lambda: nt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"),
                                        device="cuda", **kw)),
        solver, ("mu_step", "kl_divergence"))
    rejects = _rejects(calls["mu_step"], calls["kl_divergence"], res, cfg.check_every,
                       f"{where} jnp", seeded="initial_cost" not in kw)
    return res, secs, rejects


def phase_accel_reference(card, out):
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.solver import extrapolate

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    plain_cfg = dataclasses.replace(nt.reference_preset(), backend="pallas")
    cfg = dataclasses.replace(plain_cfg, accelerate=True)
    checks = ACCEL_ITERS // cfg.check_every
    print(f"[{card}] phase 10a: accelerated reference solve 4096x350, K=128, {ACCEL_ITERS} "
          "iterations, float32, a check every 25")
    for c in (cfg, dataclasses.replace(cfg, backend="jnp"), plain_cfg):   # warm each path
        nt.solve(x, w, h, dataclasses.replace(c, max_iter=2), device="cuda")
    where = "accel reference"
    res, secs, launches, rejects = _counted_accel(x, w, h, cfg, where)
    out["launches"][where] = launches
    hist = _accel_history(res, where, checks)
    _same_bits(res, nt.solve(x, w, h, cfg, device="cuda"), where)
    jres, j_secs, j_rejects = _plain_accel(x, w, h, cfg, where)
    cost, j_cost = float(res.cost), float(jres.cost)
    rel = abs(cost - j_cost) / abs(j_cost)
    check(rel <= 1e-4, f"{where}: cost {cost} vs the jnp accelerated solve {j_cost}: rel {rel}")
    check(j_rejects == rejects, f"{where}: {rejects} rejects, the jnp solve {j_rejects}")
    check(torch.equal(_bits(res.momentum), _bits(jres.momentum)),
          f"{where}: momentum {float(res.momentum)} vs jnp {float(jres.momentum)}")
    pres, p_secs = _timed(lambda: nt.solve(x, w, h, plain_cfg, device="cuda"))
    p_cost = float(pres.cost)
    check(cost <= p_cost, f"{where}: cost {cost} above the plain kernel solve's {p_cost}")
    reach = int(np.argmax(hist <= p_cost)) if bool(np.any(hist <= p_cost)) else None
    reach_its = None if reach is None else (reach + 1) * cfg.check_every
    # it/s in turns: accelerated through K1-K3, accelerated plain, plain
    # through K1-K3, twice
    its = {"accel": [], "accel_jnp": [], "plain": []}
    for _ in range(2):
        for key, c in (("accel", cfg), ("accel_jnp", dataclasses.replace(cfg, backend="jnp")),
                       ("plain", plain_cfg)):
            its[key].append(ACCEL_ITERS / _timed(lambda: nt.solve(x, w, h, c, device="cuda"))[1])
    # the reject path on the card: a baseline below any cost rejects the
    # first block, redone with K1/K2 from its start (no seed cost)
    fres, _, f_launches, f_rejects = _counted_accel(x, w, h, cfg, f"{where} initial_cost=0",
                                                    initial_cost=0.0)
    check(f_rejects >= 1, f"{where} initial_cost=0: no block rejected")
    fj, _, fj_rejects = _plain_accel(x, w, h, cfg, f"{where} initial_cost=0", initial_cost=0.0)
    f_rel = abs(float(fres.cost) - float(fj.cost)) / abs(float(fj.cost))
    check(fj_rejects == f_rejects and f_rel <= 1e-4
          and torch.equal(_bits(fres.momentum), _bits(fj.momentum)),
          f"{where} initial_cost=0: rejects {f_rejects} / jnp {fj_rejects}, rel {f_rel}")
    # the extrapolation's own cost: its elementwise passes on W and H
    m = np.float32(res.momentum.item())
    w_ms = event_ms(lambda: extrapolate(res.w, pres.w, m, EPS))
    h_ms = event_ms(lambda: extrapolate(res.h, pres.h, m, EPS))
    # device busy share of one accelerated and one plain solve
    from torch.profiler import ProfilerActivity, profile

    shares = {}
    for key, c in (("accel", cfg), ("plain", plain_cfg)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, s = _timed(lambda: nt.solve(x, w, h, c, device="cuda"))
        with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            dev = _device_shares(trace)
        shares[key] = {"busy": dev["busy"] / s, "kernels_ms": 1e3 * dev["kernels"], "wall_ms": 1e3 * s}
    out["accel"]["reference"] = {
        "rejects": rejects, "momentum": float(res.momentum), "cost": cost, "jnp_cost": j_cost,
        "plain_cost": p_cost, "reach_plain_cost_its": reach_its, "its": its,
        "extrap_ms": {"w": w_ms, "h": h_ms}, "profile": shares}
    print(f"[{card}] {where}: launches {launches} ({rejects} rejects), cost {cost}, history "
          f"{hist.tolist()}, momentum {float(res.momentum)}, bitwise on rerun; jnp accelerated "
          f"cost {j_cost} (rel {rel}, limit 1e-4, {j_rejects} rejects, momentum bit-equal); plain "
          f"kernel solve cost {p_cost}, reached by the accelerated history at iteration "
          f"{reach_its}; it/s accelerated {its['accel']}, accelerated jnp {its['accel_jnp']}, "
          f"plain kernels {its['plain']} (first timed runs {ACCEL_ITERS / secs}, "
          f"{ACCEL_ITERS / j_secs}, {ACCEL_ITERS / p_secs})")
    print(f"[{card}] {where} initial_cost=0: launches {f_launches} ({f_rejects} reject), "
          f"cost {float(fres.cost)} (jnp {float(fj.cost)}, rel {f_rel}), momentum "
          f"{float(fres.momentum)} bit-equal to jnp's")
    print(f"[{card}] {where}: extrapolation {w_ms} ms on W (4096x128), {h_ms} ms on H (128x350) "
          f"a call (CUDA events); profiled: accelerated busy {shares['accel']['busy']} "
          f"({shares['accel']['kernels_ms']} ms of kernels in {shares['accel']['wall_ms']} ms), "
          f"plain busy {shares['plain']['busy']} ({shares['plain']['kernels_ms']} ms in "
          f"{shares['plain']['wall_ms']} ms)")


def phase_accel_flagship(card, out):
    import nmf_tpu_torch as nt

    m, n, k, iters = ACCEL_FLAGSHIP
    print(f"[{card}] phase 10b: accelerated flagship {m}x{n}, K={k}, {iters} iterations")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((m, n), generator=g, device="cuda")
    w = torch.rand((m, k), generator=g, device="cuda")
    h = torch.rand((k, n), generator=g, device="cuda")
    for dtype, limit in (("bfloat16", 1e-3), ("float32", 1e-4)):
        cfg = nt.SolveConfig(max_iter=iters, check_every=25, precision=nt.Precision(dtype),
                             accelerate=True, backend="pallas")
        for backend in ("pallas", "jnp"):
            nt.solve(x, w, h, dataclasses.replace(cfg, backend=backend, max_iter=2), device="cuda")
        where = f"accel flagship {dtype}"
        res, secs, launches, rejects = _counted_accel(x, w, h, cfg, where)
        out["launches"][where] = launches
        hist = _accel_history(res, where, iters // 25)
        jres, j_secs, j_rejects = _plain_accel(x, w, h, cfg, where)
        cost, j_cost = float(res.cost), float(jres.cost)
        rel = abs(cost - j_cost) / abs(j_cost)
        check(rel <= limit, f"{where}: cost {cost} vs jnp {j_cost}: rel {rel} (limit {limit})")
        _, secs2 = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))
        _, j_secs2 = _timed(lambda: nt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"),
                                             device="cuda"))
        plain = dataclasses.replace(cfg, accelerate=False)
        pres, p_secs = _timed(lambda: nt.solve(x, w, h, plain, device="cuda"))
        its = {"accel": [iters / secs, iters / secs2], "accel_jnp": [iters / j_secs, iters / j_secs2],
               "plain": iters / p_secs}
        out["accel"][f"flagship {dtype}"] = {"rejects": rejects, "jnp_rejects": j_rejects,
                                            "cost": cost, "jnp_cost": j_cost,
                                            "plain_cost": float(pres.cost), "its": its}
        print(f"[{card}] {where}: launches {launches} ({rejects} rejects; jnp {j_rejects}), cost "
              f"{cost} (jnp {j_cost}, rel {rel}, limit {limit}; plain kernel solve "
              f"{float(pres.cost)}), history {hist.tolist()}; it/s accelerated {its['accel']}, "
              f"accelerated jnp {its['accel_jnp']}, plain kernels {its['plain']}")
    del x, w, h
    torch.cuda.empty_cache()


def phase_accel_tiled(card, out):
    import nmf_tpu_torch as nt

    m, n, k, t, occ, seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    print(f"[{card}] phase 10c: accelerated tile-sparse solve {m}x{n}, K={k}, "
          f"{tx.tiles.shape[0]} {t}x{t} tiles, {TS_ITERS} iterations")
    for dtype, limit in (("float32", 1e-4), ("bfloat16", 1e-3)):
        cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, precision=nt.Precision(dtype),
                             accelerate=True, backend="pallas")
        for backend in ("pallas", "jnp"):
            _ts_solve(tx, w, h, dataclasses.replace(cfg, backend=backend, max_iter=2))
        where = f"accel tiled {dtype}"
        (res, secs), launches, plain_calls, dense = _counted(lambda: _ts_solve(tx, w, h, cfg))
        extra = launches["h_numerator"] - TS_ITERS
        check(extra >= 0 and extra % 25 == 0, f"{where}: K5 launches {launches}")
        rejects = extra // 25
        want = dict.fromkeys(("h_numerator", "w_numerator"), TS_ITERS + 25 * rejects)
        check(launches == want and not any(plain_calls.values()) and not any(dense.values()),
              f"{where}: K5 launches {launches} (expected {want}), plain calls {plain_calls}, "
              f"K1-K3 {dense}")
        out["launches"][where] = launches
        hist = _accel_history(res, where, TS_ITERS // 25)
        res2, secs2 = _ts_solve(tx, w, h, cfg)
        _same_bits(res, res2, where)
        jres, j_secs = _ts_solve(tx, w, h, dataclasses.replace(cfg, backend="jnp"))
        rel = abs(float(res.cost) - float(jres.cost)) / abs(float(jres.cost))
        check(rel <= limit, f"{where}: cost {float(res.cost)} vs the jnp tiled accelerated solve "
              f"{float(jres.cost)}: rel {rel} (limit {limit})")
        out["accel"][f"tiled {dtype}"] = {"rejects": rejects, "cost": float(res.cost),
                                         "its": [TS_ITERS / secs, TS_ITERS / secs2],
                                         "jnp_its": TS_ITERS / j_secs}
        print(f"[{card}] {where}: K5 {launches} ({rejects} rejects), cost {float(res.cost)} "
              f"(jnp {float(jres.cost)}, rel {rel}, limit {limit}), history {hist.tolist()}, "
              f"byte-identical on rerun; {TS_ITERS / secs} and {TS_ITERS / secs2} it/s through "
              f"K5, {TS_ITERS / j_secs} it/s plain sweep")


def phase_accel_oocore(card, out, seed):
    import gc

    import nmf_tpu_torch as nt

    m, n, k = OOC_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    xd = torch.rand((m, n), generator=g, device="cuda").clamp_min_(EPS)
    w = torch.rand((m, k), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    h = torch.rand((k, n), generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
    x = xd.cpu().numpy()
    del xd
    blocks = -(-n // nt.pick_block_n(m, n))
    cfg = nt.SolveConfig(max_iter=OOC_ITERS, check_every=OOC_CHECK, accelerate=True,
                         backend="pallas")
    print(f"[{card}] phase 10d: accelerated streamed solve {m}x{n}, K={k}, {blocks} blocks, "
          f"{OOC_ITERS} iterations, a check every {OOC_CHECK}")
    for xdt in ("float32", "int8"):
        c = dataclasses.replace(cfg, precision=nt.Precision(x_dtype=xdt))
        mem, mem_secs = _timed(lambda: nt.solve(x, w, h, c, device="cuda"))
        mem_cost, mem_mom = float(mem.cost), float(mem.momentum)
        del mem
        gc.collect()
        torch.cuda.empty_cache()
        where = f"accel oocore {xdt}"
        res, secs, launches, plain_calls = _ooc_solve(x, w, h, c)
        rejects = _rejects(launches["update_h"], launches["kl_cost"], res, OOC_CHECK, where,
                           blocks=blocks)
        steps = blocks * (OOC_ITERS + OOC_CHECK * rejects)
        want = _launches(update_h=steps, update_w_numerator=steps,
                         kl_cost=blocks * (1 + int(res.num_checks) + rejects))
        check(launches == want and not any(plain_calls.values()),
              f"{where}: launches {launches} (expected {want}), plain calls {plain_calls}")
        out["launches"][where] = launches
        hist = _accel_history(res, where, OOC_ITERS // OOC_CHECK)
        cost = float(res.cost)
        rel = abs(cost - mem_cost) / abs(mem_cost)
        check(rel <= 1e-5, f"{where}: cost {cost} vs the in-memory accelerated solve {mem_cost}: "
              f"rel {rel}")
        res2, secs2, _, _ = _ooc_solve(x, w, h, c)
        for f in ("w", "h", "cost_history"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f} differs on a rerun")
        out["accel"][f"oocore {xdt}"] = {"rejects": rejects, "cost": cost, "rel_vs_memory": rel,
                                        "its": [OOC_ITERS / secs, OOC_ITERS / secs2]}
        print(f"[{card}] {where}: launches {launches} ({rejects} rejects), cost {cost}, history "
              f"{hist.tolist()}, momentum {float(res.momentum)}; in-memory accelerated solve "
              f"cost {mem_cost} (rel {rel}, limit 1e-5; momentum {mem_mom}; {OOC_ITERS / mem_secs} "
              f"it/s incl. its upload); byte-identical on rerun; {OOC_ITERS / secs} and "
              f"{OOC_ITERS / secs2} it/s")
        del res, res2
        gc.collect()
        torch.cuda.empty_cache()


def phase_accel(card, out, seed):
    print(f"[{card}] phase 10: accelerate=True on the reference, flagship, tile-sparse and "
          "streamed solves")
    phase_accel_reference(card, out)
    phase_accel_flagship(card, out)
    phase_accel_tiled(card, out)
    phase_accel_oocore(card, out, seed)


def _accel_launches(launches, name):
    """A kernel's launches on each accelerated solve of phase 10 (the
    streamed ones under K1's and K2's ``numerator_only`` key where it ran)."""
    out = {}
    for run, counts in launches.items():
        if not run.startswith("accel "):
            continue
        for key in (name, f"{name}_numerator"):
            if counts.get(key):
                out[run[6:] + ("" if key == name else " numerator_only")] = counts[key]
    return out


# ---------------------------------------------------------------------------
# Phase 11: the beta, penalized and HALS families (plain ops by rule)

# the reference solve's families: name -> SolveConfig fields
FAMILY_RUNS = {
    "beta2": dict(beta=2.0),
    "beta0": dict(beta=0.0),
    "beta0.5": dict(beta=0.5),
    "beta3": dict(beta=3.0),
    "hals": dict(beta=2.0, algorithm="hals"),
    "kl l1_h=l2_w=0.1": dict(l1_h=0.1, l2_w=0.1),
    "beta2 accelerate": dict(beta=2.0, accelerate=True),
    "hals accelerate": dict(beta=2.0, algorithm="hals", accelerate=True),
}
FAMILY_ITERS = 200
FAMILY_HALS_ITERS = 100   # HALS is launch-bound (~1656 launches an iteration): half the depth
FAMILY_COST_RTOL = 1e-4   # the card's final cost against the same solve on the CPU
DEVICE = "cuda"           # phases 11 and 12 run their solves here


def _all_counts():
    """Every kernel count, K1-K3's and K5's launches and plain calls."""
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    return {**dict(fused_mu.LAUNCHES), **{f"plain {k}": v for k, v in fused_mu.PLAIN_CALLS.items()},
            **{f"K5 {k}": v for k, v in ts.LAUNCHES.items()},
            **{f"K5 plain {k}": v for k, v in ts.PLAIN_CALLS.items()}}


def _reset_all():
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    fused_mu.reset_counts()
    ts.reset_counts()


def _kernel_launches(fn) -> int:
    """Kernels the card ran for ``fn()`` (torch.profiler, CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        events = json.loads(pathlib.Path(trace).read_text())["traceEvents"]
    return sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")


def phase_families(card, out):
    """The beta, penalized and HALS families at the reference fixtures:
    plain ops on the card by rule (no K1-K3 or K5 launch), each against the
    same solve on the CPU, a bitwise rerun, it/s; one HALS sweep timed."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops import hals
    from nmf_tpu_torch.ops.mu import matmul

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    print(f"[{card}] phase 11: the beta, penalized and HALS families, {x.shape[0]}x{x.shape[1]}, "
          f"K={w.shape[1]}, {FAMILY_ITERS} iterations (HALS {FAMILY_HALS_ITERS}), float32, "
          "plain torch ops on the card by rule")
    results = {}
    for name, fields in FAMILY_RUNS.items():
        iters = FAMILY_HALS_ITERS if fields.get("algorithm") == "hals" else FAMILY_ITERS
        cfg = nt.SolveConfig(max_iter=iters, **fields)
        where = f"families {name}"
        nt.solve(x, w, h, dataclasses.replace(cfg, max_iter=2), device=DEVICE)   # warm
        _reset_all()
        res, secs = _timed(lambda: nt.solve(x, w, h, cfg, device=DEVICE))
        counts = _all_counts()
        check(not any(counts.values()), f"{where}: kernel counts {counts}")
        out["launches"][where] = {key: counts[key] for key in _launches()}
        hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
        check(int(res.iterations) == iters and hist.shape == (cfg.num_checks,)
              and bool(np.all(np.isfinite(hist))),
              f"{where}: {int(res.iterations)} iterations, history {hist}")
        monotone = cfg.beta >= 1.0 or cfg.algorithm == "hals" or cfg.accelerate
        if monotone:
            check(bool(np.all(np.diff(hist) <= 0)), f"{where}: history rises: {hist}")
        res2, secs2 = _timed(lambda: nt.solve(x, w, h, cfg, device=DEVICE))
        for f in ("w", "h", "cost_history"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f} differs on a rerun")
        t0 = time.perf_counter()
        cpu = nt.solve(x, w, h, cfg, device="cpu")
        cpu_secs = time.perf_counter() - t0
        cost, c_cpu = float(res.cost), float(cpu.cost)
        rel = abs(cost - c_cpu) / abs(c_cpu)
        check(rel <= FAMILY_COST_RTOL, f"{where}: cost {cost} vs the CPU solve {c_cpu}: rel {rel} "
              f"(limit {FAMILY_COST_RTOL})")
        results[name] = {"cost": cost, "cpu_cost": c_cpu, "rel": rel, "its": [iters / secs, iters / secs2],
                         "cpu_its": iters / cpu_secs, "monotone_checked": monotone}
        print(f"[{card}] {where}: no kernel launched (K1-K3 and K5 counts all 0), cost {cost}, "
              f"CPU {c_cpu} (rel "
              f"{rel}, limit {FAMILY_COST_RTOL}), history {hist.tolist()}"
              f"{' non-increasing' if monotone else ''}, bitwise on rerun; "
              f"{iters / secs} / {iters / secs2} it/s on the card, {iters / cpu_secs} on the CPU")
    # one HALS sweep of H and of W on the reference operands, and the
    # kernels one HALS iteration launches
    xt, wt, ht = (torch.from_numpy(a).to(DEVICE) for a in (x, w, h))
    eps = nt.SolveConfig().eps
    wtx, wtw = matmul(wt, xt, transpose_a=True), matmul(wt, wt, transpose_a=True)
    xht, hht = matmul(xt, ht, transpose_b=True), matmul(ht, ht, transpose_b=True)
    sweep_h = event_ms(lambda: hals.cd_sweep_h(ht, wtx, wtw, eps), samples=5, calls=5)
    sweep_w = event_ms(lambda: hals.cd_sweep_w(wt, xht, hht, eps), samples=5, calls=5)
    step_ms = event_ms(lambda: hals.hals_step(wt, ht, xt, eps), samples=5, calls=5)
    per_iter = _kernel_launches(lambda: hals.hals_step(wt, ht, xt, eps))
    results["hals_sweep"] = {"h_ms": sweep_h, "w_ms": sweep_w, "step_ms": step_ms,
                             "launches_per_iteration": per_iter}
    out["families"] = results
    print(f"[{card}] families HALS: one sweep of H's {w.shape[1]} rows {sweep_h} ms, of W's "
          f"columns {sweep_w} ms, one iteration {step_ms} ms (CUDA events); {per_iter} kernel "
          f"launches an iteration (torch.profiler): K sequential row updates, launch-bound")


# ---------------------------------------------------------------------------
# Phase 12: the H-only path: solve_h_only, solve_w_only, transform_out_of_core,
# NMF and the CLI's transform (K1 and K3)

TR_SHAPE = (1025, 4000, 32)         # the ISMIR spectrogram (bench.py:54-59): M, N, K
TR_ITERS = 200
TR_OOC_ITERS = 50                   # a block's H-only iterations at the hour of audio
TR_OOC_CLI_BLOCK = 1024


def _tr_policies():
    import nmf_tpu_torch as nt

    return {"float32": nt.Precision(), "bfloat16": nt.Precision("bfloat16"),
            "float32_fast": nt.Precision("float32_fast"),
            "x_bfloat16": nt.Precision(x_dtype="bfloat16"), "x_int8": nt.Precision(x_dtype="int8")}


def _counted_kl(fn, where, want):
    """(fn(), host seconds, K3's Mode) with every count set to 0 just
    before: K1-K3 launched exactly ``want``, no plain call, and every K3
    launch in one Mode, F32 or ANY (the H-only cost's f32 recon), never
    BF16."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    _reset_all()
    (res, secs), counts = kl_counts(lambda: _timed(fn))
    launches = dict(fused_mu.LAUNCHES)
    check(launches == want and not any(fused_mu.PLAIN_CALLS.values()),
          f"{where}: launches {launches}, plain calls {fused_mu.PLAIN_CALLS}, expected {want}")
    mode = _mode_of_counts(counts, f"{where} K3") if want["kl_cost"] else None
    check(mode != "BF16", f"{where}: K3 ran its BF16 instance (the H-only cost is f32)")
    return res, secs, mode, launches


def _tr_problem(seed):
    """X (M x N, on the host), W from a 200-iteration solve, and an H0,
    all made on the card from ``seed``."""
    import nmf_tpu_torch as nt

    m, n, k = TR_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(seed + 12)
    rand = lambda *s: torch.rand(s, generator=g, device=DEVICE).clamp_min_(EPS)  # noqa: E731
    x, w0, h0, h_start = rand(m, n), rand(m, k), rand(k, n), rand(k, n)
    fit = nt.solve(x, w0, h0, nt.reference_preset(), device=DEVICE)
    return (x.cpu().numpy(), fit.w.cpu().numpy(), fit.h.cpu().numpy(), h_start.cpu().numpy(),
            float(fit.cost))


def phase_transform_h_only(card, out, x, w, h_fit, h0):
    import nmf_tpu_torch as nt

    m, n, k = TR_SHAPE
    want = _launches(update_h=TR_ITERS, kl_cost=TR_ITERS // 25)
    print(f"[{card}] phase 12a: solve_h_only and solve_w_only, {TR_ITERS} iterations")
    results = {}
    for pol, prec in _tr_policies().items():
        cfg = nt.SolveConfig(max_iter=TR_ITERS, precision=prec, backend="pallas")
        where = f"transform h_only {pol}"
        nt.solve_h_only(x, w, h0, dataclasses.replace(cfg, max_iter=2), device=DEVICE)  # warm
        res, secs, mode, launches = _counted_kl(
            lambda: nt.solve_h_only(x, w, h0, cfg, device=DEVICE), where, want)
        f32_operands = prec.x_dtype == "float32" and prec.state_dtype == "float32"
        check(mode == ("F32" if f32_operands else "ANY"), f"{where}: K3 ran {mode}")
        out["launches"][where] = launches
        hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
        check(hist.shape == (8,) and bool(np.all(np.isfinite(hist))) and bool(np.all(np.diff(hist) <= 0)),
              f"{where}: history {hist}")
        res2, secs2 = _timed(lambda: nt.solve_h_only(x, w, h0, cfg, device=DEVICE))
        for f in ("h", "cost_history"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
                  f"{where}: {f} differs on a rerun")
        plain, p_secs = _timed(lambda: nt.solve_h_only(
            x, w, h0, dataclasses.replace(cfg, backend="jnp"), device=DEVICE))
        cost, c_plain = float(res.cost), float(plain.cost)
        rel = abs(cost - c_plain) / abs(c_plain)
        limit = 1e-3 if prec.matmul_dtype == "bfloat16" else 1e-4
        check(rel <= limit, f"{where}: cost {cost} vs the jnp H-only solve {c_plain}: rel {rel}")
        results[pol] = {"its": [TR_ITERS / secs, TR_ITERS / secs2], "jnp_its": TR_ITERS / p_secs,
                        "cost": cost, "jnp_cost": c_plain, "rel": rel,
                        "k3": kl_instance(mode, k)}
        print(f"[{card}] {where} {m}x{n}, K={k}: launches {launches}, K3 {kl_instance(mode, k)}, "
              f"cost {cost} (jnp {c_plain}, rel {rel}, limit {limit}), bitwise on rerun; "
              f"{TR_ITERS / secs} / {TR_ITERS / secs2} it/s through K1 and K3, "
              f"{TR_ITERS / p_secs} plain")
    # solve_w_only: the H-only solve of the transposed problem
    cfg = nt.SolveConfig(max_iter=TR_ITERS, backend="pallas")
    where = "transform w_only float32"
    w_start = np.ascontiguousarray(np.roll(w, 1, axis=0))
    res, secs, mode, launches = _counted_kl(
        lambda: nt.solve_w_only(x, w_start, h_fit, cfg, device=DEVICE), where, want)
    check(mode == "F32", f"{where}: K3 ran {mode}")
    out["launches"][where] = launches
    plain = nt.solve_w_only(x, w_start, h_fit, dataclasses.replace(cfg, backend="jnp"),
                            device=DEVICE)
    rel = abs(float(res.cost) - float(plain.cost)) / abs(float(plain.cost))
    fro = float(torch.linalg.norm(res.w - plain.w) / torch.linalg.norm(plain.w))
    check(tuple(res.w.shape) == (m, k) and tuple(res.h.shape) == (k, n)
          and res.w.is_contiguous(), f"{where}: W {tuple(res.w.shape)}, H {tuple(res.h.shape)}")
    check(rel <= 1e-4 and fro <= 1e-4, f"{where}: cost rel {rel}, W relative Frobenius {fro} "
          "against the jnp W-only solve (limits 1e-4)")
    results["w_only"] = {"its": TR_ITERS / secs, "rel": rel, "w_fro": fro}
    print(f"[{card}] {where}: {TR_ITERS} K1 launches on the transposed problem ({launches}), "
          f"cost {float(res.cost)} (jnp {float(plain.cost)}, rel {rel}), W relative Frobenius "
          f"{fro} (limits 1e-4), {TR_ITERS / secs} it/s")
    out["transform"]["h_only"] = results


def phase_transform_oocore(card, out, seed, w):
    import gc

    import nmf_tpu_torch as nt

    m, n, k = OOC_SHAPE
    check(w.shape == (m, k), f"W {w.shape} for the hour of audio")
    g = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    x = torch.rand((m, n), generator=g, device=DEVICE).clamp_min_(EPS).cpu().numpy()
    h0 = torch.rand((k, n), generator=g, device=DEVICE).clamp_min_(EPS).cpu().numpy()
    bn = nt.pick_block_n(m, n)
    blocks = -(-n // bn)
    checks = TR_OOC_ITERS // 25
    print(f"[{card}] phase 12b: transform_out_of_core {m}x{n}, K={k}: X {x.nbytes / 1e9} GB f32 "
          f"in {blocks} blocks of {bn}, {TR_OOC_ITERS} H-only iterations a block, one stream of X")
    want = _launches(update_h=blocks * TR_OOC_ITERS, kl_cost=blocks * checks)
    rate = h2d_rate(4 * m * bn)
    results = {"h2d_gbps": rate / 1e9}
    for xdt in ("float32", "int8"):
        cfg = nt.SolveConfig(max_iter=TR_OOC_ITERS, precision=nt.Precision(x_dtype=xdt),
                             backend="pallas")
        where = f"transform_out_of_core {xdt}"
        t0 = time.perf_counter()
        mem = nt.solve_h_only(x, w, h0, cfg, device=DEVICE)
        mem_h, mem_cost = mem.h.cpu(), float(mem.cost)
        mem_secs = time.perf_counter() - t0
        del mem
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (res, secs, mode, launches), host = _host_timed(lambda: _counted_kl(
            lambda: nt.transform_out_of_core(x, w, h0=h0, config=cfg, device=DEVICE), where, want))
        peak = torch.cuda.max_memory_allocated()
        check(len(host["_fill"]) == blocks, f"{where}: {len(host['_fill'])} block fills")
        fill_s = sum(host["_fill"])
        out["launches"][f"transform out_of_core {xdt}"] = launches
        check(res.blocks == [(j, min(j + bn, n)) for j in range(0, n, bn)]
              and list(res.iterations) == [TR_OOC_ITERS] * blocks and not res.converged.any(),
              f"{where}: blocks {res.blocks}, iterations {res.iterations}")
        check(res.h.shape == (k, n) and bool(np.isfinite(res.h).all()), f"{where}: H not finite")
        summed = float(np.sum(res.block_costs, dtype=np.float64))
        rel = abs(summed - mem_cost) / abs(mem_cost)
        check(rel <= 1e-5 and abs(res.cost - summed) <= 1e-6 * abs(summed),
              f"{where}: block costs sum to {summed} (cost {res.cost}) vs the in-memory "
              f"solve_h_only {mem_cost}: rel {rel} (limit 1e-5)")
        h_rel = _max_rel(torch.from_numpy(res.h), mem_h)
        check(h_rel <= OOC_FACTOR_RTOL, f"{where}: H vs the in-memory solve: max rel {h_rel} "
              f"(limit {OOC_FACTOR_RTOL})")
        check(peak < x.nbytes / 3, f"{where}: peak device memory {peak} B not under a third of "
              f"X ({x.nbytes} B)")
        wire = x.nbytes // (4 if xdt == "int8" else 1)
        roof = wire / rate
        results[xdt] = {"its": TR_OOC_ITERS / secs, "seconds": secs, "fill_share": fill_s / secs,
                        "fill_ms_median": 1e3 * statistics.median(host["_fill"]),
                        "rel": rel, "h_rel": h_rel,
                        "peak_gb": peak / 1e9, "roofline_s": roof, "roofline_fraction": roof / secs,
                        "k3": kl_instance(mode, k), "in_memory_its": TR_OOC_ITERS / mem_secs}
        print(f"[{card}] {where}: launches {launches}, K3 {kl_instance(mode, k)}, cost "
              f"{res.cost}, block costs summed {summed} vs the in-memory solve_h_only {mem_cost} "
              f"(rel {rel}, limit 1e-5), H max rel {h_rel} (limit {OOC_FACTOR_RTOL}); "
              f"{secs} s = {TR_OOC_ITERS / secs} full-width it/s; H2D {rate / 1e9} GB/s "
              f"(pinned), {wire / 1e9} GB on the wire, roofline {roof} s = {roof / secs} of it "
              f"reached; block fills (host clock: gather, cast or quantization into pinned "
              f"memory) {fill_s / secs} of the wall, median "
              f"{1e3 * statistics.median(host['_fill'])} ms a block; peak device memory "
              f"{peak / 1e9} GB; in-memory {TR_OOC_ITERS / mem_secs} it/s incl. its upload")
    out["transform"]["oocore"] = results


def phase_transform_nmf(card, out, x, seed):
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu

    m, n, k = TR_SHAPE
    where = "transform NMF"
    print(f"[{card}] phase 12c: NMF(n_components={k}, init='nndsvda') fit, transform, "
          "normalize_factors")
    est = nt.NMF(n_components=k, init="nndsvda", backend="pallas", device=DEVICE)
    _reset_all()
    _, fit_secs = _timed(lambda: est.fit(x))
    launches = dict(fused_mu.LAUNCHES)
    check(launches == _launches(update_h=200, update_w=200, kl_cost=8),
          f"{where} fit: launches {launches}")
    g = torch.Generator(device=DEVICE).manual_seed(seed + 14)
    x_new = torch.rand((m, 1000), generator=g, device=DEVICE).cpu().numpy()
    h_new, secs, mode, t_launches = _counted_kl(lambda: est.transform(x_new), f"{where}.transform",
                                                _launches(update_h=200, kl_cost=8))
    out["launches"]["transform NMF.transform"] = t_launches
    check(est.w_.shape == (m, k) and h_new.shape == (k, 1000) and bool(np.isfinite(h_new).all())
          and np.isfinite(est.reconstruction_err_) and est.n_iter_ == 200,
          f"{where}: W {est.w_.shape}, H {h_new.shape}, err {est.reconstruction_err_}")
    wn, hn = nt.normalize_factors(est.w_, h_new)
    before = est.w_.astype(np.float64) @ h_new.astype(np.float64)
    after = wn.astype(np.float64) @ hn.astype(np.float64)
    inv = float(np.max(np.abs(after - before) / np.abs(before)))
    check(inv <= 1e-6 and np.allclose(wn.sum(axis=0), 1.0, rtol=1e-5),
          f"{where}: normalize_factors moved W H by {inv} (limit 1e-6)")
    out["transform"]["nmf"] = {"fit_its": 200 / fit_secs, "transform_its": 200 / secs,
                               "reconstruction_err": est.reconstruction_err_, "invariance": inv}
    print(f"[{card}] {where}: fit {m}x{n} K={k} (nndsvda) launches {launches}, "
          f"reconstruction_err_ {est.reconstruction_err_}, {200 / fit_secs} it/s incl. the init; "
          f"transform of {m}x1000 new columns launches {t_launches}, K3 {kl_instance(mode, k)}, "
          f"{200 / secs} it/s; normalize_factors: W H moved by {inv} relative (limit 1e-6)")


def phase_transform_cli(card, tmp, out, x, w):
    """``transform`` (in memory and ``--out-of-core``) and ``run`` with a
    family, as subprocesses, each file byte-equal to the in-process result."""
    import nmf_tpu_torch as nt

    m, n, k = TR_SHAPE
    print(f"[{card}] phase 12d: the CLI's transform and run with a family, as subprocesses")
    nt.write_matrix(x, os.path.join(tmp, "tr_X.bin"))
    nt.write_matrix(w, os.path.join(tmp, "tr_W.bin"))
    xf, wf = (nt.read_matrix(os.path.join(tmp, f"tr_{s}.bin")) for s in "XW")
    _cli(["transform", "tr_X.bin", "tr_W.bin", "-o", "tr_H.bin", "-q"], tmp)
    h0 = np.random.RandomState(0).rand(k, n).astype(np.float32)
    ref = nt.solve_h_only(xf, wf, h0, nt.SolveConfig(), device=DEVICE).h.cpu().numpy()
    check(nt.read_matrix(os.path.join(tmp, "tr_H.bin")).tobytes() == ref.tobytes(),
          "CLI transform: H differs from the in-process solve_h_only")
    bn = TR_OOC_CLI_BLOCK
    _cli(["transform", "tr_X.bin", "tr_W.bin", "-o", "tr_Hooc.bin", "--out-of-core",
          "--block-n", str(bn), "-q"], tmp)
    ref = nt.transform_out_of_core(os.path.join(tmp, "tr_X.bin"), wf, block_n=bn,
                                   device=DEVICE).h
    check(nt.read_matrix(os.path.join(tmp, "tr_Hooc.bin")).tobytes() == ref.tobytes(),
          "CLI transform --out-of-core: H differs from the in-process transform_out_of_core")
    print(f"[{card}] CLI transform {m}x{n} K={k}, in memory and --out-of-core --block-n {bn}: "
          "files byte-equal to the in-process solve_h_only / transform_out_of_core")
    _cli(["gen", "."], tmp)
    xr, wr, hr = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XWH")
    runs = {"beta2": (["--beta", "2"], dict(beta=2.0)),
            "hals": (["--algorithm", "hals", "--beta", "2"], dict(beta=2.0, algorithm="hals")),
            "l1_h": (["--l1-h", "0.1"], dict(l1_h=0.1))}
    cli = {}
    for tag, (flags, fields) in runs.items():
        _cli(["run", "X.bin", "W.bin", "H.bin", "-o", f"W_{tag}.bin", f"H_{tag}.bin", "-q",
              "--jsonl", f"{tag}.jsonl", *flags], tmp)
        res = nt.solve(xr, wr, hr, nt.SolveConfig(**fields), device=DEVICE)
        for f in "WH":
            got = nt.read_matrix(os.path.join(tmp, f"{f}_{tag}.bin"))
            check(got.tobytes() == getattr(res, f.lower()).cpu().numpy().tobytes(),
                  f"CLI run {' '.join(flags)}: {f} differs from the in-process solve")
        rec = json.loads(pathlib.Path(tmp, f"{tag}.jsonl").read_text().splitlines()[-1])
        cli[tag] = {"final_cost": rec["final_cost"], "its": rec["iters_per_sec"]}
        print(f"[{card}] CLI run X.bin W.bin H.bin {' '.join(flags)}: files byte-equal to the "
              f"in-process solve, final cost {rec['final_cost']}, {rec['iters_per_sec']} it/s")
    out["transform"]["cli"] = cli


def phase_transform(card, tmp, out, seed):
    m, n, k = TR_SHAPE
    print(f"[{card}] phase 12: the H-only path at the ISMIR shape {m}x{n}, K={k} (X from "
          f"--seed, W from a 200-iteration solve): solve_h_only, solve_w_only, "
          f"transform_out_of_core, NMF, CLI transform")
    x, w, h_fit, h0, fit_cost = _tr_problem(seed)
    out["transform"]["w_fit_cost"] = fit_cost
    phase_transform_h_only(card, out, x, w, h_fit, h0)
    phase_transform_oocore(card, out, seed, w)
    phase_transform_nmf(card, out, x, seed)
    phase_transform_cli(card, tmp, out, x, w)


def _transform_launches(launches, name):
    """A kernel's launches on each run of phase 12."""
    return {run[10:]: counts[name] for run, counts in launches.items()
            if run.startswith("transform ")}


# ---------------------------------------------------------------------------
# Phase 13: the models of Queue 1 step 6: separate and solve_semi on K1-K3,
# the masked solves, the streamed families, the online learner and their CLI

PAPER_RATE, PAPER_SECONDS = 44_100, 20       # the paper's clip: 20 s at 44.1 kHz
PAPER_FFT, PAPER_HOP, PAPER_K = 1024, 256, 32
MODELS_ITERS = 200
SEMI_FROZEN = 8
MASK_MISSING = 0.2                           # (d): the reference fixtures' missing share
STREAM_MISSING = 0.1                         # (e): the hour of audio's
STREAM_ITERS = 5                             # (e): one cost pass, at the last iteration
ONLINE_INNER = 20
ONLINE_SMALL = (1025, 4000, 32, 500)         # (f): W against the CPU run, M N K block_n
MODELS_CLI_ITERS = 50                        # (g): the streamed CLI runs


def _paper_audio(seed, seconds=PAPER_SECONDS):
    """Mono audio made on the host from ``seed``: four tones under slow
    envelopes and a short noise burst every half second (a drum stand-in),
    peak 1, f32."""
    rng = np.random.RandomState(seed)
    t = np.arange(PAPER_RATE * seconds) / PAPER_RATE
    audio = np.zeros_like(t)
    for f in rng.uniform(110.0, 1760.0, size=4):
        audio += np.sin(2 * np.pi * f * t) * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.1, 0.5) * t))
    burst = int(0.05 * PAPER_RATE)
    for start in range(0, t.size - burst, PAPER_RATE // 2):
        audio[start:start + burst] += rng.randn(burst) * np.exp(-np.arange(burst) / (0.01 * PAPER_RATE))
    return (audio / np.abs(audio).max()).astype(np.float32)


def _separate_timed(fn):
    """(fn(), {"stft", "solve", "masks": host seconds}) with the STFT, the
    solve (synchronized) and the Wiener masks and ISTFTs timed apart."""
    from nmf_tpu_torch.models import semi, separation

    times = {"stft": 0.0, "solve": 0.0, "masks": 0.0}
    patched = [(separation, "_stft_np", "stft", False), (separation, "solve", "solve", True),
               (semi, "solve_semi", "solve", True),
               (separation, "_masked_sources", "masks", False)]
    originals = [(mod, name, getattr(mod, name)) for mod, name, _, _ in patched]

    def timed(f, key, sync):
        def call(*a, **k):
            t0 = time.perf_counter()
            r = f(*a, **k)
            if sync:
                torch.cuda.synchronize()
            times[key] += time.perf_counter() - t0
            return r
        return call

    for (mod, name, key, sync), (_, _, f) in zip(patched, originals):
        setattr(mod, name, timed(f, key, sync))
    try:
        return fn(), times
    finally:
        for mod, name, f in originals:
            setattr(mod, name, f)


def _covered_samples(w, h, n_samples):
    """Samples every frame over which has W H >= 1e-12 in all bins (where
    the Wiener masks of all components sum to 1)."""
    bad = ~(w.astype(np.float64) @ h.astype(np.float64) >= 1e-12).all(axis=0)
    pad = PAPER_FFT // 2
    touched = np.zeros(n_samples + 2 * pad + PAPER_FFT, np.int64)
    for f in np.flatnonzero(bad):
        touched[f * PAPER_HOP: f * PAPER_HOP + PAPER_FFT] += 1
    return touched[pad: pad + n_samples] == 0


def _counted_models(fn, where, want):
    """(fn(), host seconds, launches): every count set to 0 just before,
    K1-K3 launched exactly ``want`` (``_launches``' keys), no plain call
    and no K5 launch."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    _reset_all()
    res, secs = _timed(fn)
    counts = _all_counts()
    launches = dict(fused_mu.LAUNCHES)
    rest = {k: v for k, v in counts.items() if k not in launches}
    check(launches == want and not any(rest.values()),
          f"{where}: launches {launches}, other counts {rest}, expected {want}")
    return res, secs, launches


def _torch_stft_checked(card, audio, spec):
    """The torch ``stft`` and ``istft`` on the card at the paper's clip:
    each within 1e-5 of the peak of the host ``_stft_np`` / ``_istft_np``
    (the ISTFT of the same host spectrogram), bit-equal on a rerun (the
    overlap-add has no atomics), and their seconds beside the host's."""
    from nmf_tpu_torch.models import separation

    def over_peak(ours, ref):
        return float(np.abs(ours - ref).max() / np.abs(ref).max())

    fwd = lambda: separation.stft(audio, PAPER_FFT, PAPER_HOP, device=DEVICE)  # noqa: E731
    inv = lambda: separation.istft(spec, PAPER_FFT, PAPER_HOP, length=audio.size,  # noqa: E731
                                   device=DEVICE)
    fwd(), inv()                                   # warm: cuFFT plans
    (s_t, s_secs), (i_t, i_secs) = _timed(fwd), _timed(inv)
    s_host, i_host = _timed(lambda: separation._stft_np(audio, PAPER_FFT, PAPER_HOP)), _timed(
        lambda: separation._istft_np(spec, PAPER_FFT, PAPER_HOP, audio.size))
    s_np, i_np = s_t.cpu().numpy(), i_t.cpu().numpy()
    s_err = over_peak(s_np, spec)
    i_err = over_peak(i_np, i_host[0])
    check(s_t.is_cuda and i_t.is_cuda and s_np.shape == spec.shape and i_np.shape == audio.shape
          and s_err <= 1e-5 and i_err <= 1e-5,
          f"torch stft/istft on the card: {s_np.shape} / {i_np.shape}, {s_err} / {i_err} of the "
          "peak from the host's (limit 1e-5)")
    check(fwd().cpu().numpy().tobytes() == s_np.tobytes()
          and inv().cpu().numpy().tobytes() == i_np.tobytes(),
          "torch stft/istft on the card: differ on a rerun")
    print(f"[{card}] torch stft/istft on the card: {s_err} / {i_err} of the peak from _stft_np / "
          f"_istft_np (limit 1e-5), bitwise on rerun; seconds stft {s_secs} (host {s_host[1]}), "
          f"istft {i_secs} (host {i_host[1]})")
    return {"stft_err": s_err, "istft_err": i_err, "stft_seconds": s_secs,
            "istft_seconds": i_secs, "host_stft_seconds": s_host[1],
            "host_istft_seconds": i_host[1]}


def phase_models_separate(card, tmp, out, seed):
    """(a) separate at the paper's workload; (b) with 8 frozen templates."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import separation

    audio = _paper_audio(seed)
    n_bins = PAPER_FFT // 2 + 1
    cfg = nt.SolveConfig(max_iter=MODELS_ITERS, thresh=0.0, check_every=25, backend="pallas")
    want = _launches(update_h=MODELS_ITERS, update_w=MODELS_ITERS, kl_cost=MODELS_ITERS // 25)
    print(f"[{card}] phase 13a: separate, {PAPER_SECONDS} s at {PAPER_RATE} Hz "
          f"({audio.size} samples from --seed), n_fft {PAPER_FFT}, hop {PAPER_HOP}, "
          f"K={PAPER_K}, {MODELS_ITERS} iterations, thresh 0")
    kw = dict(n_components=PAPER_K, n_fft=PAPER_FFT, hop=PAPER_HOP, config=cfg, seed=seed,
              device=DEVICE)
    nt.separate(audio[:PAPER_RATE], **{**kw, "config": dataclasses.replace(cfg, max_iter=2)})  # warm
    (res, parts), secs, launches = _counted_models(
        lambda: _separate_timed(lambda: nt.separate(audio, **kw)), "models separate", want)
    out["launches"]["models separate"] = launches
    spec = separation._stft_np(audio, PAPER_FFT, PAPER_HOP)
    check(spec.shape == (n_bins, 3446) and res.w.shape == (n_bins, PAPER_K)
          and res.h.shape == (PAPER_K, 3446) and res.sources.shape == (PAPER_K, audio.size)
          and bool(np.isfinite(res.sources).all()),
          f"separate: X {spec.shape}, W {res.w.shape}, H {res.h.shape}, sources "
          f"{res.sources.shape}")
    covered = _covered_samples(res.w, res.h, audio.size)
    peak = float(np.abs(audio).max())
    mix_err = float(np.abs(res.sources.sum(axis=0, dtype=np.float64) - audio)[covered].max()) / peak
    check(covered.mean() > 0.99 and mix_err <= 1e-4,
          f"separate: the sources sum to the mixture within {mix_err} of the peak on "
          f"{covered.mean()} of the samples (limit 1e-4)")
    mag = np.abs(spec).astype(np.float32)
    w0, h0 = nt.scaled_random_init(mag, PAPER_K, seed=seed)
    plain, p_secs = _timed(lambda: nt.solve(mag, w0, h0, dataclasses.replace(cfg, backend="jnp"),
                                            device=DEVICE))
    cost, c_plain = float(res.solve_result.cost), float(plain.cost)
    rel = abs(cost - c_plain) / abs(c_plain)
    check(rel <= 1e-4, f"separate: cost {cost} vs the jnp solve {c_plain}: rel {rel}")
    again = nt.separate(audio, **kw)
    check(again.sources.tobytes() == res.sources.tobytes() and again.w.tobytes() == res.w.tobytes()
          and again.h.tobytes() == res.h.tobytes(), "separate: differs on a rerun")
    hist = res.solve_result.cost_history.cpu().numpy()
    check(hist.shape == (8,) and bool(np.all(np.diff(hist) < 0)), f"separate: history {hist}")
    results = {"launches": launches, "seconds": secs, "host_seconds": parts, "cost": cost,
               "jnp_cost": c_plain, "rel": rel, "mix_err_over_peak": mix_err,
               "covered_share": float(covered.mean()), "solve_its": MODELS_ITERS / parts["solve"],
               "jnp_its": MODELS_ITERS / p_secs}
    print(f"[{card}] separate: X {n_bins}x{spec.shape[1]}, launches {launches}, cost {cost} (jnp "
          f"{c_plain}, rel {rel}, limit 1e-4), history {hist.tolist()}, sources sum to the "
          f"mixture within {mix_err} of the peak on {covered.mean()} of the samples (limit "
          f"1e-4), bitwise on rerun; host seconds: STFT {parts['stft']}, solve {parts['solve']} "
          f"({MODELS_ITERS / parts['solve']} it/s through K1-K3; jnp {MODELS_ITERS / p_secs}), "
          f"Wiener masks and {PAPER_K} ISTFTs {parts['masks']}, all {secs}")
    results["torch_stft"] = _torch_stft_checked(card, audio, spec)
    from scipy.io import wavfile

    wavfile.write(os.path.join(tmp, "paper.wav"), PAPER_RATE, (audio * 32767).astype(np.int16))

    # (b) 8 templates learned from a separate clip, frozen in the mix's solve
    print(f"[{card}] phase 13b: separate(w_template=...), {SEMI_FROZEN} templates learned from a "
          f"5 s clip of --seed + 1, frozen")
    clip = _paper_audio(seed + 1, seconds=5)
    tmpl = nt.separate(clip, n_components=SEMI_FROZEN, n_fft=PAPER_FFT, hop=PAPER_HOP, config=cfg,
                       seed=seed, device=DEVICE).w
    res_t, secs_t, launches_t = _counted_models(
        lambda: nt.separate(audio, w_template=tmpl, **kw), "models separate templates", want)
    out["launches"]["models separate templates"] = launches_t
    clamped = np.ascontiguousarray(np.maximum(tmpl, np.float32(EPS)))
    check(np.ascontiguousarray(res_t.w[:, :SEMI_FROZEN]).tobytes() == clamped.tobytes(),
          "separate(w_template): the frozen columns moved")
    free_moved = not np.array_equal(res_t.w[:, SEMI_FROZEN:], res.w[:, SEMI_FROZEN:])
    adapt = nt.separate(audio, w_template=tmpl, adapt_template=True, **kw)
    moved = float(np.abs(adapt.w[:, :SEMI_FROZEN] - clamped).max() / np.abs(clamped).max())
    check(moved > 0 and free_moved and bool(np.isfinite(res_t.sources).all()),
          f"separate(adapt_template=True): templates moved by {moved}")
    results["templates"] = {"launches": launches_t, "seconds": secs_t,
                            "cost": float(res_t.solve_result.cost),
                            "adapt_cost": float(adapt.solve_result.cost), "adapt_moved": moved}
    print(f"[{card}] separate(w_template): launches {launches_t}, the {SEMI_FROZEN} frozen columns "
          f"bit-equal to the clamped templates, cost {float(res_t.solve_result.cost)}, {secs_t} s; "
          f"adapt_template=True moves them by {moved} of their peak, cost "
          f"{float(adapt.solve_result.cost)}")
    out["models"]["separate"] = results


def phase_models_semi(card, out, seed):
    """(c) solve_semi at the ISMIR shape."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.solver import to_state

    m, n, k = TR_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(seed + 15)
    rand = lambda *s: torch.rand(s, generator=g, device=DEVICE).clamp_min_(EPS)  # noqa: E731
    x, w, h = (t.cpu().numpy() for t in (rand(m, n), rand(m, k), rand(k, n)))
    print(f"[{card}] phase 13c: solve_semi {m}x{n}, K={k} (X from --seed), {MODELS_ITERS} "
          f"iterations")
    cfg = nt.SolveConfig(max_iter=MODELS_ITERS, backend="pallas")
    want = _launches(update_h=MODELS_ITERS, update_w=MODELS_ITERS, kl_cost=MODELS_ITERS // 25)
    results = {}
    semi0 = nt.solve_semi(x, w, h, cfg, n_frozen=0, device=DEVICE)
    ref = nt.solve(x, w, h, cfg, device=DEVICE)
    for f in ("w", "h", "cost_history"):
        check(torch.equal(_bits(getattr(semi0, f)), _bits(getattr(ref, f))),
              f"solve_semi(n_frozen=0): {f} differs from the kernel solve")
    semik = nt.solve_semi(x, w, h, cfg, n_frozen=k, device=DEVICE)
    h_only = nt.solve_h_only(x, w, h, cfg, device=DEVICE)
    check(torch.equal(_bits(semik.h), _bits(h_only.h)),
          "solve_semi(n_frozen=K): H differs from solve_h_only's")
    print(f"[{card}] solve_semi n_frozen=0: W, H and history bit-equal to solve; n_frozen={k}: "
          "H bit-equal to solve_h_only")
    for pol, prec in _tr_policies().items():
        c = dataclasses.replace(cfg, precision=prec)
        where = f"models semi {pol}"
        fn = lambda: nt.solve_semi(x, w, h, c, n_frozen=SEMI_FROZEN, device=DEVICE)  # noqa: E731
        (res, secs, launches), k3 = kl_counts(lambda: _counted_models(fn, where, want))
        impls = _check_impls(fn, prec, where)
        k3_mode = _mode_of_counts(k3, f"{where} K3")
        # the solve's cost: BF16 under bfloat16, F32 on f32 X, ANY on bf16 or int8 X
        k3_want = ("BF16" if prec.matmul_dtype == "bfloat16"
                   else "F32" if prec.x_dtype == "float32" else "ANY")
        check(k3_mode == k3_want, f"{where}: K3 ran {k3_mode}, expected {k3_want}")
        w_prep = to_state(w, c, torch.device(DEVICE))
        out["launches"][where] = launches
        check(torch.equal(_bits(res.w[:, :SEMI_FROZEN]), _bits(w_prep[:, :SEMI_FROZEN])),
              f"{where}: the frozen columns moved")
        hist = res.cost_history.cpu().numpy()
        check(bool(np.all(np.diff(hist) <= 0)), f"{where}: history rises: {hist}")
        plain, p_secs = _timed(lambda: nt.solve_semi(
            x, w, h, dataclasses.replace(c, backend="jnp"), n_frozen=SEMI_FROZEN, device=DEVICE))
        rel = abs(float(res.cost) - float(plain.cost)) / abs(float(plain.cost))
        limit = 1e-3 if prec.matmul_dtype == "bfloat16" else 1e-4
        check(rel <= limit, f"{where}: cost {float(res.cost)} vs the jnp semi solve "
              f"{float(plain.cost)}: rel {rel} (limit {limit})")
        results[pol] = {"launches": launches, "impls": impls, "k3": kl_instance(k3_mode, k),
                        "cost": float(res.cost), "jnp_cost": float(plain.cost), "rel": rel,
                        "its": MODELS_ITERS / secs, "jnp_its": MODELS_ITERS / p_secs}
        print(f"[{card}] {where} n_frozen={SEMI_FROZEN}: launches {launches}, K1/K2 {impls}, K3 "
              f"{kl_instance(k3_mode, k)}, frozen columns bit-equal, cost {float(res.cost)} (jnp "
              f"{float(plain.cost)}, rel {rel}, limit {limit}), {MODELS_ITERS / secs} it/s, jnp "
              f"{MODELS_ITERS / p_secs}")
    c = dataclasses.replace(cfg, accelerate=True)
    res, secs = _timed(lambda: nt.solve_semi(x, w, h, c, n_frozen=SEMI_FROZEN, device=DEVICE))
    w_prep = to_state(w, c, torch.device(DEVICE))
    check(torch.equal(_bits(res.w[:, :SEMI_FROZEN]), _bits(w_prep[:, :SEMI_FROZEN])),
          "solve_semi accelerate: the frozen columns moved")
    _accel_history(res, "solve_semi accelerate", 8)
    results["accelerate"] = {"cost": float(res.cost), "its": MODELS_ITERS / secs,
                             "momentum": float(res.momentum)}
    print(f"[{card}] solve_semi accelerate n_frozen={SEMI_FROZEN}: frozen columns bit-equal, "
          f"history non-increasing, cost {float(res.cost)} (plain {results['float32']['cost']}), "
          f"{MODELS_ITERS / secs} it/s")
    out["models"]["semi"] = results


def phase_models_masked(card, out, seed):
    """(d) solve_masked and solve_masked_h_only at the reference fixtures."""
    import nmf_tpu_torch as nt

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    mask = (np.random.RandomState(seed + 16).rand(*x.shape) >= MASK_MISSING).astype(np.float32)
    xn = x.copy()
    xn[mask == 0] = np.nan
    cfg = nt.SolveConfig(max_iter=MODELS_ITERS)
    none = _launches()
    print(f"[{card}] phase 13d: solve_masked and solve_masked_h_only {x.shape[0]}x{x.shape[1]}, "
          f"K={w.shape[1]}, {MASK_MISSING} of X missing (NaN), {MODELS_ITERS} iterations, plain "
          "torch ops by rule")
    results = {}
    for name, fn in (("solve_masked", lambda d, c: nt.solve_masked(xn, w, h, mask, c, device=d)),
                     ("solve_masked_h_only",
                      lambda d, c: nt.solve_masked_h_only(xn, w, h, mask, c, device=d))):
        where = f"models {name}"
        fn(DEVICE, dataclasses.replace(cfg, max_iter=2))   # warm
        res, secs, launches = _counted_models(lambda: fn(DEVICE, cfg), where, none)
        out["launches"][where] = launches
        check(bool(torch.isfinite(res.w).all()) and bool(torch.isfinite(res.h).all()),
              f"{where}: factors not finite")
        again = fn(DEVICE, cfg)
        for f in ("w", "h", "cost_history"):
            check(torch.equal(_bits(getattr(res, f)), _bits(getattr(again, f))),
                  f"{where}: {f} differs on a rerun")
        t0 = time.perf_counter()
        cpu = fn("cpu", cfg)
        cpu_secs = time.perf_counter() - t0
        rel = abs(float(res.cost) - float(cpu.cost)) / abs(float(cpu.cost))
        check(rel <= 1e-5, f"{where}: cost {float(res.cost)} vs the CPU's {float(cpu.cost)}: "
              f"rel {rel} (limit 1e-5)")
        results[name] = {"cost": float(res.cost), "cpu_cost": float(cpu.cost), "rel": rel,
                         "its": MODELS_ITERS / secs, "cpu_its": MODELS_ITERS / cpu_secs}
        print(f"[{card}] {where}: launches {launches}, no K5 launch, cost {float(res.cost)} (CPU "
              f"{float(cpu.cost)}, rel {rel}, limit 1e-5), bitwise on rerun, "
              f"{MODELS_ITERS / secs} it/s on the card, {MODELS_ITERS / cpu_secs} on the CPU")
    ones = nt.solve_masked(x, w, h, np.ones_like(x), cfg, device=DEVICE)
    plain = nt.solve(x, w, h, dataclasses.replace(cfg, backend="jnp"), device=DEVICE)
    rel = abs(float(ones.cost) - float(plain.cost)) / abs(float(plain.cost))
    check(rel <= 1e-5, f"solve_masked with a mask of ones: cost {float(ones.cost)} vs the jnp "
          f"solve {float(plain.cost)}: rel {rel} (limit 1e-5)")
    results["ones_rel_vs_jnp"] = rel
    print(f"[{card}] solve_masked with a mask of ones: cost {float(ones.cost)} vs the jnp solve "
          f"{float(plain.cost)} (rel {rel}, limit 1e-5)")
    out["models"]["masked"] = results


def _hour_of_audio(seed):
    """(X, W0, H0) of phase 9's shape made on the card from ``seed``, on the host."""
    m, n, k = OOC_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(seed + 17)
    rand = lambda *s: torch.rand(s, generator=g, device=DEVICE).clamp_min_(EPS)  # noqa: E731
    return tuple(rand(*s).cpu().numpy() for s in ((m, n), (m, k), (k, n)))


STREAM_RUNS = {
    "beta2": dict(beta=2.0),
    "hals": dict(beta=2.0, algorithm="hals"),
    "kl l1_h=l2_w=0.1": dict(l1_h=0.1, l2_w=0.1),
    "masked": dict(),
    "n_frozen=8": dict(backend="pallas"),
}


def phase_models_streamed(card, out, x, w, h, seed):
    """(e) the streamed families at the hour of audio."""
    import gc

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.solver import to_state

    m, n, k = OOC_SHAPE
    bn = nt.pick_block_n(m, n)
    blocks = -(-n // bn)
    mask = (np.random.RandomState(seed + 18).rand(m, n) >= STREAM_MISSING).astype(np.float32)
    rate = h2d_rate(4 * m * bn)
    streams = STREAM_ITERS + 1
    print(f"[{card}] phase 13e: the streamed families {m}x{n}, K={k}, {blocks} blocks of {bn}, "
          f"{STREAM_ITERS} iterations and one cost pass, f32 X; H2D {rate / 1e9} GB/s (pinned)")
    results = {"h2d_gbps": rate / 1e9}
    for name, fields in STREAM_RUNS.items():
        cfg = nt.SolveConfig(max_iter=STREAM_ITERS, check_every=STREAM_ITERS, **fields)
        where = f"models streamed {name}"
        kw = {"mask": mask} if name == "masked" else (
            {"n_frozen": SEMI_FROZEN} if name.startswith("n_frozen") else {})
        if name == "masked":
            mem = nt.solve_masked(x, w, h, mask, cfg, device=DEVICE)
        elif name.startswith("n_frozen"):
            mem = nt.solve_semi(x, w, h, cfg, n_frozen=SEMI_FROZEN, device=DEVICE)
        else:
            mem = nt.solve(x, w, h, cfg, device=DEVICE)
        mem_cost = float(mem.cost)
        del mem
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        want = (_launches(update_h=blocks * STREAM_ITERS, update_w_numerator=blocks * STREAM_ITERS,
                          kl_cost=blocks) if "n_frozen" in kw else _launches())
        (res, secs, launches), host = _host_timed(lambda: _counted_models(
            lambda: nt.solve_out_of_core(x, w, h, cfg, device=DEVICE, **kw), where, want))
        peak = torch.cuda.max_memory_allocated()
        out["launches"][where] = launches
        cost = float(res.cost)
        rel = abs(cost - mem_cost) / abs(mem_cost)
        check(int(res.iterations) == STREAM_ITERS and int(res.num_checks) == 1 and np.isfinite(cost),
              f"{where}: {int(res.iterations)} iterations, {int(res.num_checks)} checks, cost {cost}")
        check(rel <= 1e-5, f"{where}: cost {cost} vs the in-memory solve {mem_cost}: rel {rel} "
              "(limit 1e-5)")
        wire = x.nbytes + (mask.nbytes if name == "masked" else 0)
        check(peak < wire / 3, f"{where}: peak device memory {peak} B not under a third of "
              f"X{' and the mask' if name == 'masked' else ''} ({wire} B)")
        if "n_frozen" in kw:
            w_prep = to_state(w, cfg, torch.device(DEVICE))
            check(torch.equal(_bits(res.w[:, :SEMI_FROZEN]), _bits(w_prep[:, :SEMI_FROZEN])),
                  f"{where}: the frozen columns moved")
        roof = streams * wire / rate
        fill_s = sum(host["_fill"])
        results[name] = {"launches": launches, "cost": cost, "in_memory_cost": mem_cost,
                         "rel": rel, "its": STREAM_ITERS / secs, "seconds": secs,
                         "wire_gb_per_stream": wire / 1e9, "roofline_s": roof,
                         "roofline_fraction": roof / secs, "fill_share": fill_s / secs,
                         "peak_gb": peak / 1e9}
        print(f"[{card}] {where}: launches {launches}, cost {cost} (in-memory {mem_cost}, rel "
              f"{rel}, limit 1e-5), {STREAM_ITERS / secs} it/s ({secs} s for {streams} streams "
              f"of {wire / 1e9} GB{' (X and the mask)' if name == 'masked' else ''}), H2D "
              f"roofline {roof} s = {roof / secs} of it reached, block fills {fill_s / secs} of "
              f"the wall, peak device memory {peak / 1e9} GB (limit {wire / 3e9})")
    out["models"]["streamed"] = results


def phase_models_online(card, out, x, w, seed):
    """(f) solve_online at the hour of audio, and W against the CPU run."""
    import nmf_tpu_torch as nt

    m, n, k = OOC_SHAPE
    bn = OOC_BLOCK
    blocks = -(-n // bn)
    cfg = nt.SolveConfig()
    print(f"[{card}] phase 13f: solve_online {m}x{n}, K={k}, one pass, inner_iters "
          f"{ONLINE_INNER}, {blocks} blocks of {bn}, plain torch ops by rule")
    fn = lambda: nt.solve_online(x, w, cfg, block_n=bn, inner_iters=ONLINE_INNER,  # noqa: E731
                                 seed=seed, device=DEVICE)
    (res, secs, launches), host = _host_timed(
        lambda: _counted_models(fn, "models online", _launches()))
    out["launches"]["models online"] = launches
    widths = np.asarray([j1 - j0 for j0, j1 in res.blocks], np.float64)
    per_col = res.learning_curve / widths
    check(len(res.blocks) == blocks and bool(np.isfinite(res.w).all())
          and per_col[-1] < per_col[0],
          f"online: {len(res.blocks)} blocks, the learning curve per column {per_col.tolist()}")
    again = fn()
    check(again.w.tobytes() == res.w.tobytes() and again.block_costs == res.block_costs,
          "online: differs on a rerun")
    fill_s = sum(host["_fill"])
    ms, ns, ks, bns = ONLINE_SMALL
    g = torch.Generator(device=DEVICE).manual_seed(seed + 19)
    xs, ws = (torch.rand(s, generator=g, device=DEVICE).clamp_min_(EPS).cpu().numpy()
              for s in ((ms, ns), (ms, ks)))
    card_w = nt.solve_online(xs, ws, cfg, block_n=bns, inner_iters=ONLINE_INNER, seed=seed,
                             device=DEVICE).w
    cpu_w = nt.solve_online(xs, ws, cfg, block_n=bns, inner_iters=ONLINE_INNER, seed=seed,
                            device="cpu").w
    fro = float(np.linalg.norm(card_w - cpu_w) / np.linalg.norm(cpu_w))
    check(fro <= 1e-5, f"online {ms}x{ns}: W relative Frobenius {fro} from the CPU run (limit 1e-5)")
    out["models"]["online"] = {"blocks_per_s": blocks / secs, "seconds": secs,
                               "fill_share": fill_s / secs, "curve_per_column": per_col.tolist(),
                               "small_w_fro_vs_cpu": fro}
    print(f"[{card}] online: launches {launches}, learning curve per column {per_col.tolist()} "
          f"(falls from the first block to the last), bitwise on rerun; {blocks / secs} blocks/s "
          f"({secs} s), block fills {fill_s / secs} of the wall; at {ms}x{ns} K={ks}, block_n "
          f"{bns}: W relative Frobenius {fro} from the CPU run (limit 1e-5)")


def _cli_all(runs, cwd):
    """Every CLI run of ``runs`` (tag -> args) as its own subprocess, all at
    once; waits for each and fails on the first that did not exit 0."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    procs = {tag: subprocess.Popen([sys.executable, "-m", "nmf_tpu_torch", *args, "-q"], cwd=cwd,
                                   env=env) for tag, args in runs.items()}
    codes = {tag: p.wait() for tag, p in procs.items()}
    check(not any(codes.values()), f"CLI runs exited {codes}")


def phase_models_cli(card, tmp, out):
    """(g) the step's CLI flags as subprocesses, each file byte-equal to its
    in-process result."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch import cli
    from nmf_tpu_torch.models import init as init_mod

    print(f"[{card}] phase 13g: run --mask / --freeze / --online / the streamed families, "
          "transform --mask and separate, as subprocesses at once")
    _cli(["gen", "."], tmp)
    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    x, w, h = (nt.read_matrix(j(f"{s}.bin")) for s in "XWH")
    mask = (np.random.RandomState(1).rand(*x.shape) >= MASK_MISSING).astype(np.float32)
    nt.write_matrix(mask, j("M.bin"))
    m, n, k, bn = OOC_CLI
    rng = np.random.RandomState(0)
    ox = np.maximum(rng.rand(m, n).astype(np.float32), np.float32(EPS))
    ow, oh = rng.rand(m, k).astype(np.float32), rng.rand(k, n).astype(np.float32)
    om = (rng.rand(m, n) >= MASK_MISSING).astype(np.float32)
    for name, a in (("X", ox), ("W", ow), ("H", oh), ("M", om)):
        nt.write_matrix(a, j(f"m_ooc_{name}.bin"))
    ooc = ["m_ooc_X.bin", "m_ooc_W.bin", "m_ooc_H.bin", "--out-of-core", "--block-n", str(bn),
           "--max-iter", str(MODELS_CLI_ITERS)]
    online_bn = 100
    runs = {
        "mask": ["run", "X.bin", "W.bin", "H.bin", "--mask", "M.bin"],
        "mask_ooc": ["run", *ooc, "--mask", "m_ooc_M.bin"],
        "freeze": ["run", "X.bin", "W.bin", "H.bin", "--freeze", str(SEMI_FROZEN)],
        "freeze_ooc": ["run", *ooc, "--freeze", str(SEMI_FROZEN)],
        "beta2_ooc": ["run", *ooc, "--beta", "2"],
        "hals_ooc": ["run", *ooc, "--algorithm", "hals", "--beta", "2"],
        "online": ["run", "X.bin", "--rank", "128", "--init", "random", "--online", "--block-n",
                   str(online_bn)],
        "tmask": ["transform", "X.bin", "W.bin", "--mask", "M.bin", "-o", "H_tmask.bin"],
        "separate": ["separate", "paper.wav", "--out-dir", "sep_cli"],
    }
    for tag, args in runs.items():
        if args[0] == "run":
            args += ["-o", f"W_{tag}.bin", f"H_{tag}.bin"]
    t0 = time.perf_counter()
    _cli_all(runs, tmp)
    wall = time.perf_counter() - t0
    cfg = nt.SolveConfig()
    ocfg = nt.SolveConfig(max_iter=MODELS_CLI_ITERS)
    src = lambda: nt.BinColumnSource(j("m_ooc_X.bin"))  # noqa: E731
    refs = {
        "mask": lambda: nt.solve_masked(x, w, h, mask, cfg, device=DEVICE),
        "mask_ooc": lambda: nt.solve_out_of_core(src(), ow, oh, ocfg, block_n=bn, device=DEVICE,
                                                 mask=nt.BinColumnSource(j("m_ooc_M.bin"))),
        "freeze": lambda: nt.solve_semi(x, w, h, cfg, n_frozen=SEMI_FROZEN, device=DEVICE),
        "freeze_ooc": lambda: nt.solve_out_of_core(src(), ow, oh, ocfg, block_n=bn,
                                                   n_frozen=SEMI_FROZEN, device=DEVICE),
        "beta2_ooc": lambda: nt.solve_out_of_core(src(), ow, oh, dataclasses.replace(ocfg, beta=2.0),
                                                  block_n=bn, device=DEVICE),
        "hals_ooc": lambda: nt.solve_out_of_core(
            src(), ow, oh, dataclasses.replace(ocfg, beta=2.0, algorithm="hals"), block_n=bn,
            device=DEVICE),
    }
    for tag, fn in refs.items():
        res = fn()
        for f in "WH":
            got = nt.read_matrix(j(f"{f}_{tag}.bin"))
            check(got.tobytes() == getattr(res, f.lower()).cpu().float().numpy().tobytes(),
                  f"CLI {' '.join(runs[tag][:-3])}: {f} differs from the in-process result")
    w0 = init_mod.random_init(x.shape[0], 128, 1, seed=0)[0]
    onl = nt.solve_online(j("X.bin"), w0, cfg, block_n=online_bn, inner_iters=20, seed=0,
                          device=DEVICE)
    tr = nt.transform_out_of_core(j("X.bin"), onl.w, config=cfg, block_n=online_bn, seed=0,
                                  device=DEVICE)
    check(nt.read_matrix(j("W_online.bin")).tobytes() == onl.w.tobytes()
          and nt.read_matrix(j("H_online.bin")).tobytes() == tr.h.tobytes(),
          "CLI run --online: files differ from solve_online + transform_out_of_core")
    h0 = np.random.RandomState(0).rand(w.shape[1], x.shape[1]).astype(np.float32)
    th = nt.solve_masked_h_only(x, w, h0, mask, cfg, device=DEVICE).h.cpu().numpy()
    check(nt.read_matrix(j("H_tmask.bin")).tobytes() == th.tobytes(),
          "CLI transform --mask: H differs from solve_masked_h_only")
    rate, audio = cli._read_wav(j("paper.wav"))
    sep = nt.separate(audio, n_components=PAPER_K, config=nt.SolveConfig(thresh=1e-5),
                      device=DEVICE)
    paths = cli.write_sources(sep.sources, rate, j("sep_inproc"))
    check(len(paths) == PAPER_K and all(
        pathlib.Path(p).read_bytes() == pathlib.Path(j("sep_cli", os.path.basename(p))).read_bytes()
        for p in paths), "CLI separate: the WAVs differ from the in-process separate")
    out["models"]["cli"] = {"wall_s": wall, "runs": list(runs)}
    print(f"[{card}] CLI: {', '.join(' '.join(a[:-3] if a[0] == 'run' else a) for a in runs.values())}"
          f": every file byte-equal to its in-process result ({len(runs)} processes at once, "
          f"{wall} s of wall)")


def phase_models(card, tmp, out, seed):
    phase_models_separate(card, tmp, out, seed)
    phase_models_semi(card, out, seed)
    phase_models_masked(card, out, seed)
    x, w, h = _hour_of_audio(seed)
    phase_models_streamed(card, out, x, w, h, seed)
    phase_models_online(card, out, x, w, seed)
    del x, w, h
    phase_models_cli(card, tmp, out)


def _models_launches(launches, name):
    """A kernel's launches on each run of phase 13, 0 included (the streamed
    ``n_frozen`` run's K1 and K2 also under their ``numerator_only`` key)."""
    out = {}
    for run, counts in launches.items():
        if run.startswith("models "):
            out[run[7:]] = counts[name]
            if counts.get(f"{name}_numerator"):
                out[run[7:] + " numerator_only"] = counts[f"{name}_numerator"]
    return out


# --- phase 14: the batched solves (ROADMAP.md Queue 1 step 7) -------------

BATCH_SHAPE = (128, 513, 2000, 32)      # (a) config 4: B, M, N, K (benchmarks/run_all.py:569)
BATCH_ITERS = 100
BATCH_CHECK = (0, 63, 127)              # members held to their 2-D solve bit for bit
SEL_SHAPE = (512, 1024, 32)             # (b)-(d): run_all.py:202-267, 574
SEL_ITERS = 100
SEL_RESTARTS = 16
SEL_FROZEN = 8
SWEEP_RANKS = [8, 16, 24, 32] * 2
STAB_RANKS, STAB_RESTARTS = [4, 8, 12, 16], 8
MASKED_MEMBERS, PLAIN_ITERS = 16, 50
TILED_BATCH = (4, 4096, 4096, 128, 128, 0.08)   # (e): phase 8's layout cut to 4096^2
STOP_MEMBERS, STOP_THRESH = 8, 1e-4
CLI_BATCH_FILES, CLI_BATCH_SHAPE, CLI_ITERS = 16, (513, 2000), 100


def _member_bits_equal(a, b):
    return _bits(a.contiguous()).cpu().numpy().tobytes() == _bits(b.contiguous()).cpu().numpy().tobytes()


def _counted_members(fn, where, want, members=None):
    """:func:`_counted_models`, and the members its launches served
    (``fused_mu.MEMBERS``), checked against ``members`` where given."""
    from nmf_tpu_torch.ops.kernels import fused_mu

    res, secs, launches = _counted_models(fn, where, want)
    served = dict(fused_mu.MEMBERS)
    if members is not None:
        check(served == members, f"{where}: members served {served}, expected {members}")
    return res, secs, launches, served


def _kl_batched_plain(x, w, h, eps=EPS):
    """K3's plain version over a member axis (true f32 recon, x -> 0 limit),
    one cost a member: the reference of the batched K3 call."""
    y = torch.clamp_min(torch.matmul(w.float(), h.float()), eps)
    xf = x.float()
    t = torch.where(xf > 0, xf * (torch.log(torch.clamp_min(xf, eps)) - torch.log(y)), 0.0) - xf + y
    return t.sum(dim=(-2, -1))


def _batched_calls(card, out, x, w, h):
    """K1-K3 once each over config 4's 128 members (f32): bits of members
    0, 63, 127 against the 2-D call, error and time against the plain
    batched version (cuBLAS batched GEMMs), the bound and the partials'
    bytes."""
    from nmf_tpu_torch.ops import mu
    from nmf_tpu_torch.ops.kernels import fused_mu

    b, m, n, k = BATCH_SHAPE
    pairs = {
        "update_h": (lambda: fused_mu.update_h_fused(w, h, x), lambda: mu.update_h(w, h, x)),
        "update_w": (lambda: fused_mu.update_w_fused(w, h, x), lambda: mu.update_w(w, h, x)),
        "kl_cost": (lambda: fused_mu.kl_cost_fused(x, w, h), lambda: _kl_batched_plain(x, w, h)),
    }
    chunks = -(-k // fused_mu.chunk_width(k))
    mt, nt = -(-m // fused_mu.TILE), -(-n // fused_mu.TILE)
    partial_bytes = {
        "update_h": b * fused_mu.plan_split(nt, chunks, mt)[0] * k * n * 4,
        "update_w": b * fused_mu.plan_split(mt, chunks, nt)[0] * m * k * 4,
        "kl_cost": b * fused_mu.kl_split(m, n, k)[3] * 4,
    }
    for name, (kern, plain) in pairs.items():
        got, ref = kern(), plain()
        rel = float((torch.abs(got - ref) / torch.abs(ref).clamp_min(1e-30)).max())
        limit = F32_TOL[2] if name == "kl_cost" else F32_TOL[0]
        check(rel <= limit, f"batched {name}: max rel {rel} to the plain batched version")
        for i in BATCH_CHECK:
            one = (fused_mu.kl_cost_fused(x[i], w[i], h[i]) if name == "kl_cost" else
                   getattr(fused_mu, f"{name}_fused")(w[i].contiguous(), h[i].contiguous(), x[i]))
            check(_member_bits_equal(got[i], one), f"batched {name}: member {i} differs from the 2-D call")
        ms, plain_ms = timed_pair(kern, plain, samples=5, calls=5)
        # K1/K2's per-member denominators (one torch.sum a member, the 2-D
        # call's bits), part of each call's time
        sums_ms = None if name == "kl_cost" else event_ms(
            lambda: fused_mu._sums(w, -2) if name == "update_h" else fused_mu._sums(h, -1),
            samples=5, calls=5)
        flops = (1 if name == "kl_cost" else 2) * 2 * b * m * n * k
        nbytes = b * (m * n + m * k + k * n) * 4 + {"update_h": b * k * n * 4, "update_w": b * m * k * 4,
                                                     "kl_cost": b * 4}[name]
        bound_ms, by = bound(flops, nbytes)
        out["kernels"][name]["batched"] = {
            "shape": list(BATCH_SHAPE), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "max_rel_err": rel, "partial_bytes": partial_bytes[name],
            "denominators_ms": sums_ms, "members_bit_equal": list(BATCH_CHECK)}
        sums = "" if sums_ms is None else f"; its {b} per-member denominators alone {sums_ms} ms"
        print(f"[{card}] batched {name} {b} x {m}x{n} K={k} f32: {ms} ms a call (one pass-1 "
              f"launch for all members{sums}), plain batched {plain_ms} ms, bound {bound_ms} ms "
              f"({by}), "
              f"max rel {rel}, partials {partial_bytes[name]} bytes, members {list(BATCH_CHECK)} "
              f"bit-equal to the 2-D call")


def phase_selection_batched(card, out, seed):
    """(a) config 4 through the kernels and through ``backend="jnp"``."""
    import nmf_tpu_torch as nt

    b, m, n, k = BATCH_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.clamp_min(torch.rand((b, m, n), generator=g, device="cuda"), EPS)
    w = torch.clamp_min(torch.rand((b, m, k), generator=g, device="cuda"), EPS)
    h = torch.clamp_min(torch.rand((b, k, n), generator=g, device="cuda"), EPS)
    _batched_calls(card, out, x, w, h)
    runs = {}
    for policy in ("float32", "bfloat16"):
        cfg = nt.SolveConfig(max_iter=BATCH_ITERS, check_every=25, track_cost=False,
                             precision=nt.Precision(policy), backend="pallas")
        nt.solve_batched(x[:2], w[:2], h[:2], dataclasses.replace(cfg, max_iter=2), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, secs, launches, served = _counted_members(
            lambda: nt.solve_batched(x, w, h, cfg, device="cuda"), f"batched {policy}",
            _launches(update_h=BATCH_ITERS, update_w=BATCH_ITERS),
            dict(_launches(update_h=b * BATCH_ITERS, update_w=b * BATCH_ITERS)))
        peak = torch.cuda.max_memory_allocated() - base
        check(res.iterations.tolist() == [BATCH_ITERS] * b, f"batched {policy}: iterations")
        for i in BATCH_CHECK:
            one = nt.solve(x[i], w[i], h[i], cfg, device="cuda")
            check(_member_bits_equal(res.w[i], one.w) and _member_bits_equal(res.h[i], one.h),
                  f"batched {policy}: member {i} differs from its 2-D solve")
        jcfg = dataclasses.replace(cfg, backend="jnp")
        nt.solve_batched(x[:2], w[:2], h[:2], dataclasses.replace(jcfg, max_iter=2), device="cuda")
        plain, plain_secs, _, _ = _counted_members(
            lambda: nt.solve_batched(x, w, h, jcfg, device="cuda"), f"batched {policy} jnp",
            _launches())
        c_k = nt.kl_divergence(x[0], res.w[0], res.h[0])
        c_p = nt.kl_divergence(x[0], plain.w[0], plain.h[0])
        rel = abs(float(c_k) - float(c_p)) / abs(float(c_p))
        check(rel <= (1e-3 if policy == "bfloat16" else 1e-4),
              f"batched {policy}: member 0 cost {float(c_k)} vs jnp {float(c_p)}")
        rate, plain_rate = b * BATCH_ITERS / secs, b * BATCH_ITERS / plain_secs
        runs[policy] = {
            "seconds": secs, "problem_iters_per_s": rate, "tflops": 8 * m * n * k * rate / 1e12,
            "jnp_seconds": plain_secs, "jnp_problem_iters_per_s": plain_rate,
            "jnp_tflops": 8 * m * n * k * plain_rate / 1e12, "peak_bytes": peak,
            "x_bytes": x.numel() * 4, "launches": launches, "members": served,
            "member0_cost_rel_to_jnp": rel}
        out["launches"][f"selection batched {policy}"] = launches
        print(f"[{card}] solve_batched {b} x {m}x{n} K={k} {policy}, {BATCH_ITERS} iterations: "
              f"{rate} problem-it/s ({8 * m * n * k * rate / 1e12} TFLOP/s) through the kernels, "
              f"{plain_rate} ({8 * m * n * k * plain_rate / 1e12}) through backend='jnp'; "
              f"launches {launches} for {served} member-calls; peak {peak} bytes over "
              f"{x.numel() * 4} of X; members {list(BATCH_CHECK)} bit-equal to their 2-D solves; "
              f"member 0 cost rel {rel} to jnp")
    out["selection"]["batched"] = runs
    del x, w, h


def _sel_problem(seed):
    """X of (b)-(d): a planted rank-32 structure and noise, on the host."""
    m, n, k = SEL_SHAPE
    rng = np.random.RandomState(seed + 14)
    x = rng.rand(m, k).astype(np.float32) @ rng.rand(k, n).astype(np.float32)
    return (x + 0.1 * rng.rand(m, n)).astype(np.float32)


def phase_selection_restarts(card, out, x):
    """(b) restarts against sequential solves, and with frozen columns."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models.init import scaled_random_init

    m, n, k = SEL_SHAPE
    r = SEL_RESTARTS
    cfg = nt.SolveConfig(max_iter=SEL_ITERS, check_every=25, backend="pallas")
    checks = SEL_ITERS // 25
    nt.solve_restarts(x, rank=k, n_restarts=2, config=dataclasses.replace(cfg, max_iter=2),
                      device="cuda")
    sel, secs, launches, served = _counted_members(
        lambda: nt.solve_restarts(x, rank=k, n_restarts=r, config=cfg, seed=0, device="cuda"),
        "restarts", _launches(update_h=SEL_ITERS, update_w=SEL_ITERS, kl_cost=checks),
        dict(_launches(update_h=r * SEL_ITERS, update_w=r * SEL_ITERS, kl_cost=r * checks)))
    out["launches"]["selection restarts"] = launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()   # the sequential solves make their inits, as solve_restarts does
    inits = [scaled_random_init(x, k, seed=i) for i in range(r)]
    ones = [nt.solve(x, w0, h0, cfg, device="cuda") for w0, h0 in inits]
    torch.cuda.synchronize()
    seq_secs = time.perf_counter() - t0
    for i, one in enumerate(ones):
        check(_member_bits_equal(sel.results.w[i], one.w) and _member_bits_equal(sel.results.h[i], one.h)
              and _member_bits_equal(sel.results.cost[i], one.cost),
              f"restarts: member {i} differs from its sequential solve")
    check(sel.best_index == int(np.argmin(sel.costs)), "restarts: best_index is not the argmin")
    f = SEL_FROZEN
    w0s = np.stack([np.concatenate([inits[0][0][:, :f], w0[:, f:]], axis=1) for w0, _ in inits])
    h0s = np.stack([h0 for _, h0 in inits])
    frz, frz_secs, _, _ = _counted_members(
        lambda: nt.solve_restarts(x, w0s=w0s, h0s=h0s, config=cfg, n_frozen=f, device="cuda"),
        "restarts n_frozen", _launches(update_h=SEL_ITERS, update_w=SEL_ITERS, kl_cost=checks))
    clamped = np.maximum(inits[0][0][:, :f], np.float32(EPS))
    check(all(frz.results.w[i, :, :f].cpu().numpy().tobytes() == clamped.tobytes() for i in range(r)),
          "restarts n_frozen: frozen columns moved")
    rate, seq_rate = r * SEL_ITERS / secs, r * SEL_ITERS / seq_secs
    out["selection"]["restarts"] = {
        "seconds": secs, "problem_iters_per_s": rate, "sequential_seconds": seq_secs,
        "sequential_problem_iters_per_s": seq_rate, "frozen_seconds": frz_secs,
        "best_index": sel.best_index, "launches": launches, "members": served}
    print(f"[{card}] solve_restarts R={r} at {m}x{n} K={k}, {SEL_ITERS} iterations: {rate} "
          f"problem-it/s against {seq_rate} for {r} sequential solves; launches {launches}; every "
          f"member bit-equal to its sequential solve; best #{sel.best_index} (argmin); "
          f"n_frozen={f}: columns bit-equal, {frz_secs} s")


def phase_selection_sweep(card, out, x):
    """(c) the rank sweep against single rank-k solves; (d) stability."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import selection, stability

    cfg = nt.SolveConfig(max_iter=SEL_ITERS, check_every=25, backend="pallas")
    checks = SEL_ITERS // 25
    sweep, secs, launches, _ = _counted_members(
        lambda: nt.solve_rank_sweep(x, SWEEP_RANKS, cfg, seed=0, device="cuda"), "rank sweep",
        _launches(update_h=SEL_ITERS, update_w=SEL_ITERS, kl_cost=checks))
    out["launches"]["selection sweep"] = launches
    w0s, h0s = selection._member_inits(x, SWEEP_RANKS, "scaled", 0)
    worst = 0.0
    for i, k in enumerate(SWEEP_RANKS):
        check(not sweep.results.w[i, :, k:].any() and not sweep.results.h[i, k:, :].any(),
              f"rank sweep: member {i}'s embedded slots are not exact zeros")
        one = nt.solve(x, w0s[i, :, :k], h0s[i, :k, :], cfg, device="cuda")
        rel = abs(float(sweep.costs[i]) - float(one.cost)) / abs(float(one.cost))
        worst = max(worst, rel)
        check(rel <= 1e-5, f"rank sweep: member {i} (rank {k}) cost rel {rel} to its rank-{k} solve")
    out["selection"]["sweep"] = {"seconds": secs, "max_cost_rel": worst, "launches": launches}
    print(f"[{card}] solve_rank_sweep {SWEEP_RANKS} at 512x1024: {secs} s, launches {launches}, "
          f"embedded slots exact zeros, costs within {worst} of the single rank-k solves")
    solve_secs = []
    inner = stability.solve_rank_sweep

    def timed_sweep(*a, **kw):
        res, s = _timed(lambda: inner(*a, **kw))
        solve_secs.append(s)
        return res

    stability.solve_rank_sweep = timed_sweep
    try:
        st, total = _timed(lambda: nt.rank_stability(
            x, STAB_RANKS, n_restarts=STAB_RESTARTS, config=cfg, seed=0, device="cuda"))
    finally:
        stability.solve_rank_sweep = inner
    check(st.cophenetic.shape == (len(STAB_RANKS),) and np.isfinite(st.cophenetic).all(),
          f"stability: cophenetic {st.cophenetic}")
    out["selection"]["stability"] = {"solve_seconds": solve_secs[0],
                                     "consensus_seconds": total - solve_secs[0],
                                     "cophenetic": st.cophenetic.tolist(), "best_rank": st.best_rank()}
    print(f"[{card}] rank_stability ranks {STAB_RANKS} x {STAB_RESTARTS} restarts at 512x1024: "
          f"solve {solve_secs[0]} s, host consensus {total - solve_secs[0]} s, cophenetic "
          f"{st.cophenetic.tolist()}, best rank {st.best_rank()}")


def phase_selection_plain(card, out, seed):
    """(e) the plain batched paths, and members stopping at their own check."""
    import nmf_tpu_torch as nt

    rng = np.random.RandomState(seed + 15)
    b, m, n, k = MASKED_MEMBERS, BATCH_SHAPE[1], BATCH_SHAPE[2], BATCH_SHAPE[3]
    xs = np.maximum(rng.rand(b, m, n).astype(np.float32), np.float32(EPS))
    ws, hs = rng.rand(b, m, k).astype(np.float32), rng.rand(b, k, n).astype(np.float32)
    masks = (rng.rand(b, m, n) >= MASK_MISSING).astype(np.float32)
    cfg = nt.SolveConfig(max_iter=PLAIN_ITERS, check_every=25)
    res, secs, _, _ = _counted_members(
        lambda: nt.solve_batched(xs, ws, hs, cfg, mask=masks, device="cuda"), "batched masked",
        _launches())
    worst = max(abs(float(res.cost[i]) - float(one.cost)) / abs(float(one.cost)) for i, one in
                enumerate(nt.solve_masked(xs[i], ws[i], hs[i], masks[i], cfg, device="cuda")
                          for i in range(b)))
    check(worst <= 1e-5, f"batched masked: cost rel {worst} to the members' solve_masked")
    out["selection"]["masked"] = {"seconds": secs, "max_cost_rel": worst}
    print(f"[{card}] solve_batched(mask=) {b} x 513x2000, 20% missing, {PLAIN_ITERS} iterations: "
          f"0 launches, {secs} s, costs within {worst} of each member's solve_masked")

    tb, tm, tn, tk, tile, occ = TILED_BATCH
    probs = [tile_problem(tm, tk, tn, tile, occ, seed=s) for s in range(tb)]
    xs_t = [p[0] for p in probs]
    ws_t, hs_t = np.stack([p[1] for p in probs]), np.stack([p[2] for p in probs])
    res, secs, _, _ = _counted_members(
        lambda: nt.solve_sparse_tiled_batched(xs_t, ws_t, hs_t, cfg, device="cuda"),
        "tiled batched", _launches())
    worst = 0.0
    for i in range(tb):
        one = nt.solve_sparse_tiled(xs_t[i], ws_t[i], hs_t[i], cfg, device="cuda")
        worst = max(worst, abs(float(res.cost[i]) - float(one.cost)) / abs(float(one.cost)))
    check(worst <= 1e-5, f"tiled batched: cost rel {worst} to the members' solve_sparse_tiled")
    out["selection"]["tiled"] = {"seconds": secs, "max_cost_rel": worst}
    print(f"[{card}] solve_sparse_tiled_batched {tb} x 4096^2 K=128, occupancy {occ}, "
          f"{PLAIN_ITERS} iterations: 0 K5 launches, {secs} s, costs within {worst} of each "
          f"member's solve_sparse_tiled (which runs K5)")

    sm, sn, sk = SEL_SHAPE
    # uniform noise raised to these powers converges at 500-900 iterations
    # at this threshold, a member a power
    powers = np.linspace(0.5, 4.0, STOP_MEMBERS)
    xs_s = np.stack([np.maximum(rng.rand(sm, sn).astype(np.float32) ** np.float32(pw),
                                np.float32(EPS)) for pw in powers])
    ws_s = rng.rand(STOP_MEMBERS, sm, sk).astype(np.float32)
    hs_s = rng.rand(STOP_MEMBERS, sk, sn).astype(np.float32)
    scfg = nt.SolveConfig(max_iter=1000, thresh=STOP_THRESH, check_every=10, backend="pallas")
    res, secs = _timed(lambda: nt.solve_batched(xs_s, ws_s, hs_s, scfg, device="cuda"))
    its = res.iterations.tolist()
    for i in range(STOP_MEMBERS):
        one = nt.solve(xs_s[i], ws_s[i], hs_s[i], scfg, device="cuda")
        check(int(one.iterations) == its[i] and _member_bits_equal(res.w[i], one.w),
              f"thresh batch: member {i} ran {its[i]} iterations, its solve {int(one.iterations)}")
    check(len(set(its)) > 1, f"thresh batch: every member stopped at {its[0]}")
    out["selection"]["thresh"] = {"iterations": its, "seconds": secs}
    print(f"[{card}] thresh={STOP_THRESH} batch of {STOP_MEMBERS}: members stopped at {its}, each "
          f"its own solve's count and bits ({secs} s)")


def phase_selection_cli(card, tmp, out, x, seed):
    """(f) batch, select --stability, run --restarts and separate --restarts
    as subprocesses at once, each file byte-equal to the same call made
    in-process."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch import cli
    from scipy.io import wavfile

    j = lambda *p: os.path.join(tmp, *p)  # noqa: E731
    rng = np.random.RandomState(seed + 16)
    os.makedirs(j("specs"))
    xs = [rng.rand(*CLI_BATCH_SHAPE).astype(np.float32) for _ in range(CLI_BATCH_FILES)]
    for i, xi in enumerate(xs):
        nt.write_matrix(xi, j("specs", f"s{i:02d}.bin"))
    nt.write_matrix(x, j("X.bin"))
    audio = _paper_audio(seed)
    wavfile.write(j("paper.wav"), PAPER_RATE, (audio * 32767).astype(np.int16))
    it = ["--max-iter", str(CLI_ITERS)]
    runs = {
        "batch": ["batch", "specs", "--rank", "32", "--out-dir", "batch_out", *it],
        "select": ["select", "X.bin", "--ranks", "8,16,24,32", "--stability", "-o", "W_sel.bin",
                   "H_sel.bin", *it],
        "restarts": ["run", "X.bin", "--rank", "32", "--restarts", "8", "-o", "W_rs.bin", "H_rs.bin",
                     *it],
        "separate": ["separate", "paper.wav", "--restarts", "4", "--out-dir", "sep_cli"],
    }
    t0 = time.perf_counter()
    _cli_all(runs, tmp)
    wall = time.perf_counter() - t0
    cfg = nt.SolveConfig(max_iter=CLI_ITERS)
    brng = np.random.RandomState(0)
    b = CLI_BATCH_FILES
    ws = brng.rand(b, CLI_BATCH_SHAPE[0], 32).astype(np.float32)
    hs = brng.rand(b, 32, CLI_BATCH_SHAPE[1]).astype(np.float32)
    res = nt.solve_batched(np.stack(xs), ws, hs, cfg, device=DEVICE)
    for i in range(b):
        for f, t in (("W", res.w[i]), ("H", res.h[i])):
            check(nt.read_matrix(j("batch_out", f"s{i:02d}.{f}.bin")).tobytes() == t.cpu().numpy().tobytes(),
                  f"CLI batch: s{i:02d}.{f}.bin differs from solve_batched")
    st = nt.rank_stability(x, [8, 16, 24, 32], n_restarts=4, config=cfg, init="scaled", device=DEVICE)
    rec = st.best_rank()
    at = np.nonzero(st.sweep.ranks == rec)[0]
    w_b, h_b = st.sweep.factors(int(at[np.argmin(st.sweep.costs[at])]))
    check(nt.read_matrix(j("W_sel.bin")).tobytes() == w_b.cpu().numpy().tobytes()
          and nt.read_matrix(j("H_sel.bin")).tobytes() == h_b.cpu().numpy().tobytes(),
          "CLI select: files differ from rank_stability")
    sel = nt.solve_restarts(x, rank=32, n_restarts=8, config=cfg, init="scaled", device=DEVICE)
    w_b, h_b = sel.best
    check(nt.read_matrix(j("W_rs.bin")).tobytes() == w_b.cpu().numpy().tobytes()
          and nt.read_matrix(j("H_rs.bin")).tobytes() == h_b.cpu().numpy().tobytes(),
          "CLI run --restarts: files differ from solve_restarts")
    rate, audio = cli._read_wav(j("paper.wav"))
    sep = nt.separate(audio, n_components=32, config=nt.SolveConfig(thresh=1e-5), n_restarts=4,
                      device=DEVICE)
    paths = cli.write_sources(sep.sources, rate, j("sep_inproc"))
    check(len(paths) == 32 and all(
        pathlib.Path(p).read_bytes() == pathlib.Path(j("sep_cli", os.path.basename(p))).read_bytes()
        for p in paths), "CLI separate --restarts: the WAVs differ from the in-process separate")
    out["selection"]["cli"] = {"wall_s": wall, "runs": list(runs), "select_rank": rec}
    print(f"[{card}] CLI batch ({b} files), select --stability (rank {rec}), run --restarts 8 and "
          f"separate --restarts 4 as subprocesses at once: every file byte-equal to its in-process "
          f"call ({wall} s of wall)")


def phase_selection(card, tmp, out, seed):
    print(f"[{card}] phase 14: batched solves, restarts, rank sweeps, stability (K1-K3 over a "
          "member axis), the plain batched paths and the CLI")
    phase_selection_batched(card, out, seed)
    x = _sel_problem(seed)
    phase_selection_restarts(card, out, x)
    phase_selection_sweep(card, out, x)
    phase_selection_plain(card, out, seed)
    phase_selection_cli(card, tmp, out, x, seed)


def _selection_launches(launches, name):
    """A kernel's launches on each run of phase 14 (one a batched launch,
    whatever its members)."""
    return {run[10:]: counts[name] for run, counts in launches.items()
            if run.startswith("selection ")}


# --- phase 15: utils (BinDataset, the native reader, checkpoints, live, profiling, doctor)

UTILS_FILES, UTILS_FILE_SHAPE = 128, (513, 2000)   # BASELINE.json config 4's input
UTILS_OOC = (1025, 65_408, 32)     # phase 9's streamed block as a whole X
# (b)'s block widths: 16352 columns (4 blocks), and 16384, whose rows lie a
# power of two apart (64 KiB) in the native reader's transpose (PR 15's
# first run: native fills 4.5x NumPy's there)
UTILS_OOC_BLOCKS = (16_352, 16_384)
UTILS_OOC_ITERS = 10
UTILS_CKPT_EVERY = 50


def _build_native(card, out):
    """``native/binio.cpp`` built with the host compiler into
    ``build/nmf_tpu_torch/native/`` (``native/`` is never written), and
    ``NMF_TPU_NATIVE_LIB`` pointed at it."""
    import shutil

    from nmf_tpu_torch.io import native

    lib = REPO / "build" / "nmf_tpu_torch" / "native" / "libnmfio.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    check(cxx is not None, "no host C++ compiler for native/binio.cpp")
    t0 = time.perf_counter()
    subprocess.run([cxx, "-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared", "-o",
                    str(lib), str(REPO / "native" / "binio.cpp")],
                   check=True, capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    os.environ["NMF_TPU_NATIVE_LIB"] = str(lib)
    os.environ.pop("NMF_TPU_NO_NATIVE", None)
    native._lib = None          # load the new build, whatever was loaded before
    check(native.available() and native.has_read_columns(), f"{lib} does not load")
    out["utils"]["native_build_s"] = secs
    print(f"[{card}] native/binio.cpp built with {cxx} into {lib} in {secs} s")


class _NumpyReads:
    """Inside: the NumPy reads (``NMF_TPU_NO_NATIVE=1``)."""

    def __enter__(self):
        os.environ["NMF_TPU_NO_NATIVE"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("NMF_TPU_NO_NATIVE", None)
        return False


def phase_utils_dataset(card, tmp, out, seed):
    """(a) BinDataset over config 4's input, native reads against NumPy's."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import native

    d = os.path.join(tmp, "specs")
    os.makedirs(d)
    rng = np.random.RandomState(seed + 15)
    for i in range(UTILS_FILES):
        nt.write_matrix(rng.rand(*UTILS_FILE_SHAPE).astype(np.float32), os.path.join(d, f"s{i:03d}.bin"))
    ds = nt.BinDataset(d)
    check(len(ds) == UTILS_FILES and ds.shape == UTILS_FILE_SHAPE, f"BinDataset: {len(ds)} x {ds.shape}")
    loads, ref = {"numpy": [], "native": []}, None
    for path in ("numpy", "native", "native", "numpy"):
        native.reset_counts()
        t0 = time.perf_counter()
        if path == "numpy":
            with _NumpyReads():
                xs = ds.load_batch()
        else:
            xs = ds.load_batch()
        loads[path].append(time.perf_counter() - t0)
        want = UTILS_FILES if path == "native" else 0
        check(native.READS["matrix"] == want, f"BinDataset {path}: {native.READS} native reads")
        if ref is None:
            ref = xs
        check(xs.shape == (UTILS_FILES, *UTILS_FILE_SHAPE) and xs.tobytes() == ref.tobytes(),
              f"BinDataset: the {path} load differs from the NumPy load")
    gb = ref.nbytes / 1e9
    out["utils"]["dataset"] = {"bytes": ref.nbytes, "numpy_s": loads["numpy"], "native_s": loads["native"]}
    print(f"[{card}] BinDataset {UTILS_FILES} x {UTILS_FILE_SHAPE} ({gb} GB, page cache): NumPy "
          f"{loads['numpy']} s, native {loads['native']} s (in turns), bit-equal")


def _ooc_problem(tmp, seed):
    """X of UTILS_OOC as a .bin file, and W0, H0."""
    import nmf_tpu_torch as nt

    m, n, k = UTILS_OOC
    rng = np.random.RandomState(seed + 150)
    path = os.path.join(tmp, "X_ooc.bin")
    nt.write_matrix(rng.rand(m, n).astype(np.float32), path)
    return path, rng.rand(m, k).astype(np.float32), rng.rand(k, n).astype(np.float32)


def _ooc_blocks(block_n):
    return -(-UTILS_OOC[1] // block_n)


def phase_utils_streamed(card, out, path, w, h):
    """(b) the streamed solve from the .bin file, native reads against
    NumPy's, at each of UTILS_OOC_BLOCKS (the first in turns, native,
    NumPy, NumPy, native; the second once each)."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import native

    cfg = nt.SolveConfig(max_iter=5, check_every=5, backend="pallas")
    rec = {}
    for block_n, order in zip(UTILS_OOC_BLOCKS, (("native", "numpy", "numpy", "native"),
                                                 ("native", "numpy"))):
        runs, first = {}, None
        for tag in order:
            native.reset_counts()
            with (_NumpyReads() if tag == "numpy" else contextlib.nullcontext()):
                (res, secs, launches, plain), fills = _host_timed(
                    lambda: _ooc_solve(path, w, h, cfg, block_n=block_n))
            reads = native.READS["columns"]
            check((reads > 0) == (tag == "native"), f"streamed {tag}: {reads} native column reads")
            check(launches["update_h"] == 5 * _ooc_blocks(block_n) and not any(plain.values()),
                  f"streamed from .bin: launches {launches}, plain {plain}")
            first = first or res
            for f in ("w", "h", "cost_history"):
                check(torch.equal(_bits(getattr(res, f)), _bits(getattr(first, f))),
                      f"streamed from .bin, block {block_n}: {f} of a {tag} run differs")
            runs.setdefault(tag, []).append({"seconds": secs, "fill_s": sum(fills["_fill"]),
                                              "fills": len(fills["_fill"]), "native_reads": reads})
        rec[block_n] = runs
        print(f"[{card}] solve_out_of_core from a {UTILS_OOC[0]}x{UTILS_OOC[1]} .bin, K={UTILS_OOC[2]}, "
              f"block {block_n} ({_ooc_blocks(block_n)} blocks), 5 iterations + 1 cost pass: native "
              f"reads {[r['native_reads'] for r in runs['native']]}; fills native "
              f"{[r['fill_s'] for r in runs['native']]} s, NumPy {[r['fill_s'] for r in runs['numpy']]} s "
              f"(sums over {runs['native'][0]['fills']} fills); solve native "
              f"{[r['seconds'] for r in runs['native']]} s, NumPy {[r['seconds'] for r in runs['numpy']]} s; "
              "factors bit-equal")
    out["utils"]["streamed"] = rec


def _state_bits_equal(a, b):
    return all(np.asarray(getattr(a, f), np.float32).tobytes() == np.asarray(getattr(b, f), np.float32).tobytes()
               for f in ("w", "h")) and np.float32(a.cost_history).tobytes() == np.float32(b.cost_history).tobytes()


def phase_utils_checkpoint(card, tmp, out):
    """(c) the checkpointed reference solve: against the straight solve,
    stopped after two segments and resumed, plain and accelerated."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import fixtures as fx
    from nmf_tpu_torch.utils import solve_with_checkpoints

    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    cfg = nt.SolveConfig(backend="pallas")
    half = dataclasses.replace(cfg, max_iter=cfg.max_iter // 2)
    straight = nt.solve(x, w, h, cfg, device="cuda")
    _, straight_s = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))
    rec = {"straight_s": straight_s}
    for name, c, hc in (("plain", cfg, half),
                        ("accelerate", dataclasses.replace(cfg, accelerate=True),
                         dataclasses.replace(half, accelerate=True))):
        d = os.path.join(tmp, f"ck_{name}")
        want = _launches(update_h=200, update_w=200, kl_cost=8) if name == "plain" else None
        if want is not None:
            full, secs, launches = _counted_models(
                lambda: solve_with_checkpoints(x, w, h, c, d + "_full", every=UTILS_CKPT_EVERY,
                                               device="cuda"), f"checkpointed {name}", want)
        else:
            _reset_all()
            full, secs = _timed(lambda: solve_with_checkpoints(x, w, h, c, d + "_full",
                                                               every=UTILS_CKPT_EVERY, device="cuda"))
            launches = _all_counts()
        out["launches"][f"utils checkpointed {name}"] = {k: launches[k] for k in _launches()}
        steps = sorted(os.listdir(d + "_full"))
        check(steps == [f"step_{i:08d}" for i in (50, 100, 150, 200)], f"checkpointed {name}: {steps}")
        check(full.iteration == 200 and len(full.cost_history) == 8, f"checkpointed {name}: {full}")
        if name == "plain":
            check(full.w.tobytes() == straight.w.cpu().numpy().tobytes()
                  and full.h.tobytes() == straight.h.cpu().numpy().tobytes()
                  and np.float32(full.cost_history).tobytes() == straight.cost_history.cpu().numpy().tobytes(),
                  "checkpointed reference solve: not the straight solve's bits")
        first, s1 = _timed(lambda: solve_with_checkpoints(x, w, h, hc, d, every=UTILS_CKPT_EVERY,
                                                          device="cuda"))
        check(sorted(os.listdir(d)) == steps[:2], f"{name}: stopped run wrote {os.listdir(d)}")
        _reset_all()
        resumed, s2 = _timed(lambda: solve_with_checkpoints(x, w, h, c, d, every=UTILS_CKPT_EVERY,
                                                            device="cuda"))
        res_launches = {k: v for k, v in _all_counts().items() if k in _launches()}
        check(_state_bits_equal(resumed, full) and resumed.check_iterations == full.check_iterations,
              f"checkpointed {name}: the resumed run differs from the uninterrupted one")
        if name == "accelerate":
            check(np.float32(resumed.momentum) == np.float32(full.momentum)
                  and np.asarray(resumed.w_ex).tobytes() == np.asarray(full.w_ex).tobytes(),
                  "accelerated resume: momentum or carry differs")
        rec[name] = {"seconds": secs, "launches": out["launches"][f"utils checkpointed {name}"],
                     "stopped_s": s1, "resumed_s": s2, "resumed_launches": res_launches,
                     "final_cost": full.cost_history[-1]}
        print(f"[{card}] solve_with_checkpoints reference {name}, every {UTILS_CKPT_EVERY}: {secs} s, "
              f"launches {rec[name]['launches']}; stopped at 100 ({s1} s) and resumed ({s2} s, "
              f"launches {res_launches}): bit-equal to the uninterrupted run"
              + (f"; the straight solve's bits (straight: {straight_s} s)" if name == "plain" else ""))
    out["utils"]["checkpoint"] = rec


def phase_utils_streamed_ckpt(card, tmp, out, path, w, h):
    """(d) the streamed solve's checkpoint and resume at (b)'s shape."""
    import nmf_tpu_torch as nt

    block_n = UTILS_OOC_BLOCKS[0]
    blocks, half = _ooc_blocks(block_n), UTILS_OOC_ITERS // 2
    cfg = nt.SolveConfig(max_iter=UTILS_OOC_ITERS, check_every=half, backend="pallas")
    kw = dict(block_n=block_n, checkpoint_every=half)
    full, secs, launches, plain = _ooc_solve(path, w, h, cfg, checkpoint_dir=os.path.join(tmp, "sf"), **kw)
    want = _launches(update_h=UTILS_OOC_ITERS * blocks, update_w_numerator=UTILS_OOC_ITERS * blocks,
                     kl_cost=2 * blocks)
    check(launches == want and not any(plain.values()),
          f"streamed checkpointed: launches {launches}, plain {plain}, expected {want}")
    out["launches"]["utils streamed checkpointed"] = launches
    d = os.path.join(tmp, "sc")
    _ooc_solve(path, w, h, dataclasses.replace(cfg, max_iter=half), checkpoint_dir=d, **kw)
    check(sorted(os.listdir(d)) == [f"step_{half:08d}"], f"streamed stopped run wrote {os.listdir(d)}")
    resumed, s2, l2, _ = _ooc_solve(path, w, h, cfg, checkpoint_dir=d, **kw)
    for f in ("w", "h", "cost_history"):
        check(torch.equal(_bits(getattr(resumed, f)), _bits(getattr(full, f))),
              f"streamed resume: {f} differs from the uninterrupted run")
    out["utils"]["streamed_ckpt"] = {"seconds": secs, "launches": launches, "resumed_s": s2,
                                     "resumed_launches": l2}
    print(f"[{card}] solve_out_of_core checkpointed every {half} of {UTILS_OOC_ITERS} (block "
          f"{block_n}): {secs} s, launches {launches}; stopped at {half} and resumed ({s2} s, "
          f"launches {l2}): bit-equal")


def phase_utils_tiled_ckpt(card, tmp, out):
    """(e) the checkpointed tile-sparse solve at 8192^2, K=128 (K5)."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.utils import solve_with_checkpoints

    m, n, k, t, occ, seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    cfg = nt.SolveConfig(max_iter=TS_ITERS, check_every=25, backend="pallas")
    straight, _ = _ts_solve(tx, w, h, cfg)
    d = os.path.join(tmp, "tiled")
    (full, k5, k5_plain, k13), secs = _timed(lambda: _counted(
        lambda: solve_with_checkpoints(tx, w, h, cfg, d + "_full", every=UTILS_CKPT_EVERY,
                                       device="cuda")))
    check(k5 == {"h_numerator": TS_ITERS, "w_numerator": TS_ITERS} and not any(k5_plain.values())
          and not any(k13.values()), f"checkpointed tiled: K5 {k5}, plain {k5_plain}, K1-K3 {k13}")
    out["launches"]["utils tiled checkpointed"] = {**_launches(), **k5}
    check(full.w.tobytes() == straight.w.cpu().numpy().tobytes()
          and full.h.tobytes() == straight.h.cpu().numpy().tobytes(),
          "checkpointed tiled: not the straight tiled solve's bits")
    solve_with_checkpoints(tx, w, h, dataclasses.replace(cfg, max_iter=TS_ITERS // 2), d,
                           every=UTILS_CKPT_EVERY, device="cuda")
    resumed, s2 = _timed(lambda: solve_with_checkpoints(tx, w, h, cfg, d, every=UTILS_CKPT_EVERY,
                                                        device="cuda"))
    check(_state_bits_equal(resumed, full), "checkpointed tiled: the resumed run differs")
    out["utils"]["tiled_ckpt"] = {"seconds": secs, "k5": k5, "resumed_s": s2}
    print(f"[{card}] solve_with_checkpoints tile-sparse {m}^2 K={k}, every {UTILS_CKPT_EVERY}: {secs} s, "
          f"K5 {k5}; the straight solve's bits; stopped at {TS_ITERS // 2} and resumed ({s2} s): bit-equal")


def phase_utils_live(card, out):
    """(f) live metrics on the reference solve."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import fixtures as fx
    from nmf_tpu_torch.utils import metrics

    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    on_cfg = nt.SolveConfig(live_metrics=True, backend="pallas")
    off_cfg = nt.SolveConfig(backend="pallas")
    events = []
    metrics.set_live_handler(lambda *e: events.append(e))
    try:
        on, _, launches = _counted_models(lambda: nt.solve(x, w, h, on_cfg, device="cuda"), "live",
                                          _launches(update_h=200, update_w=200, kl_cost=8))
        out["launches"]["utils live"] = launches
        times = {"off": [], "on": []}
        for tag in ("off", "on", "on", "off"):
            cfg = on_cfg if tag == "on" else off_cfg
            _, secs = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))
            times[tag].append(secs)
    finally:
        metrics.set_live_handler(None)
    off = nt.solve(x, w, h, off_cfg, device="cuda")
    for f in ("w", "h", "cost_history"):
        check(torch.equal(_bits(getattr(on, f)), _bits(getattr(off, f))), f"live: {f} differs from live off")
    hist = on.cost_history.cpu().numpy()
    first = events[:8]
    check([e[0] for e in first] == [25 * (i + 1) for i in range(8)]
          and np.float32([e[1] for e in first]).tobytes() == hist.tobytes() and np.isnan(first[0][2]),
          f"live: emissions {first} against the history {hist}")
    check(len(events) == 8 * 3, f"live: {len(events)} emissions over three live solves")
    its = {tag: [200 / s for s in v] for tag, v in times.items()}
    out["utils"]["live"] = {"it_per_s": its, "launches": launches}
    print(f"[{card}] live metrics on the reference solve: 8 emissions = the history, factors "
          f"bit-equal to live off; it/s on {its['on']}, off {its['off']} (in turns)")


def phase_utils_profiling(card, tmp, out):
    """(g) stage_timings at the reference shape; trace names K1 and K2."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import fixtures as fx
    from nmf_tpu_torch.utils import profiling

    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    st = profiling.stage_timings(x, w, h, repeats=20)
    check(set(st) == {"recon_divide", "h_numerator", "w_numerator", "sums", "epilogues", "kl_cost",
                      "full_step", "fused_step", "null_dispatch"} and all(v > 0 for v in st.values()),
          f"stage_timings: {st}")
    log = os.path.join(tmp, "trace")
    with profiling.trace(log):
        nt.solve(x, w, h, nt.SolveConfig(max_iter=5, check_every=5, backend="pallas"),
                 device="cuda")
    path = os.path.join(log, "trace.json")
    names = {e.get("name", "") for e in json.loads(pathlib.Path(path).read_text())["traceEvents"]
             if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in names if k in n)[:1] for k in ("h_update_partial", "w_update_partial")}
    check(all(found.values()), f"trace: no K1/K2 kernel among {sorted(names)[:20]}")
    out["utils"]["stage_ms"] = {k: v * 1e3 for k, v in st.items()}
    print(f"[{card}] stage_timings at 4096x350 K=128 (ms, best of 20, CUDA events): "
          f"{json.dumps(out['utils']['stage_ms'])}; trace {os.path.getsize(path)} bytes naming "
          f"{found['h_update_partial'][0][:40]} and {found['w_update_partial'][0][:40]}")


def phase_utils_doctor(card, out):
    """(h) ``python -m nmf_tpu_torch doctor --json`` in a subprocess."""
    proc = subprocess.run([sys.executable, "-m", "nmf_tpu_torch", "doctor", "--json"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"doctor: exit {proc.returncode}: {proc.stderr[-400:]}")
    rep = json.loads(proc.stdout)
    kind = torch.cuda.get_device_name(0)
    check(rep["up"] is True and rep["backend"]["device_kind"] == kind
          and rep["backend"]["platform"] == "cuda", f"doctor: {rep}")
    out["utils"]["doctor"] = {k: rep["backend"][k] for k in ("device_kind", "dispatch_s", "h2d_gbps",
                                                             "d2h_gbps")}
    out["utils"]["doctor"]["kernel_build"] = rep["kernel_build"]
    print(f"[{card}] doctor --json: up, {kind}, H2D {rep['backend']['h2d_gbps']} GB/s, D2H "
          f"{rep['backend']['d2h_gbps']} GB/s, kernel build {rep['kernel_build']}")


def phase_utils(card, tmp, out, seed):
    print(f"[{card}] phase 15: utils (BinDataset and the native reader, checkpoint/resume, live "
          "metrics, profiling, doctor)")
    _build_native(card, out)
    phase_utils_dataset(card, tmp, out, seed)
    path, w, h = _ooc_problem(tmp, seed)
    phase_utils_streamed(card, out, path, w, h)
    phase_utils_checkpoint(card, tmp, out)
    phase_utils_streamed_ckpt(card, tmp, out, path, w, h)
    phase_utils_tiled_ckpt(card, tmp, out)
    phase_utils_live(card, out)
    phase_utils_profiling(card, tmp, out)
    phase_utils_doctor(card, out)


def _utils_launches(launches, name):
    """A kernel's launches on each run of phase 15."""
    return {run[6:]: counts.get(name, 0) for run, counts in launches.items()
            if run.startswith("utils ")}


SPARSE_ITERS, SPARSE_CHECK = 20, 5      # phase 16: the COO solve at phase 8's layout
SPARSE_RTOL = 1e-5                      # cost and factors (relative Frobenius) vs the dense solve


def _rel_fro(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_sparse(card, out):
    """16: the COO ``solve_sparse`` at phase 8's tile-sparse layout."""
    import warnings

    import nmf_tpu_torch as nt

    m, n, k, t, occ, seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, seed)
    sx = nt.sparse_from_dense(x)
    nnz = int(sx.data.shape[0])
    cfg = nt.SolveConfig(max_iter=SPARSE_ITERS, check_every=SPARSE_CHECK)
    print(f"[{card}] phase 16: COO solve_sparse {m}x{n}, K={k}, {nnz} nonzeros ({t}x{t} tiles at "
          f"occupancy {occ}, seed {seed}), {SPARSE_ITERS} iterations, a check every {SPARSE_CHECK}")

    def coo():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return nt.solve_sparse(sx, w, h, cfg, device="cuda")

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (res, secs), k5, k5_plain, k13 = _counted(lambda: _timed(coo))
    peak = torch.cuda.max_memory_allocated() - base
    check(not any(k5.values()) and not any(k5_plain.values()) and not any(k13.values()),
          f"sparse: kernel launches K1-K3 {k13}, K5 {k5}, K5 plain {k5_plain} (expected none)")
    hist = res.cost_history.cpu().numpy()[: int(res.num_checks)]
    check(int(res.iterations) == SPARSE_ITERS and hist.shape == (SPARSE_ITERS // SPARSE_CHECK,)
          and bool(np.all(np.isfinite(hist)) and np.all(np.diff(hist) < 0)),
          f"sparse: {int(res.iterations)} iterations, history {hist}")
    res2, secs2 = _timed(coo)
    for f in ("w", "h", "cost_history"):
        check(torch.equal(_bits(getattr(res, f)), _bits(getattr(res2, f))),
              f"sparse: {f} differs on a rerun")
    eps = np.float32(EPS)
    dense, d_secs = _timed(lambda: nt.solve(x, np.maximum(w, eps), np.maximum(h, eps), cfg,
                                            clamp_inputs=False, device="cuda"))
    c_rel = abs(float(res.cost) - float(dense.cost)) / abs(float(dense.cost))
    w_rel, h_rel = _rel_fro(res.w, dense.w), _rel_fro(res.h, dense.h)
    check(max(c_rel, w_rel, h_rel) <= SPARSE_RTOL,
          f"sparse: vs the dense clamp_inputs=False solve: cost rel {c_rel}, W {w_rel}, H {h_rel} "
          f"(limit {SPARSE_RTOL})")
    tx = nt.tiles_from_dense(x, (t, t))
    tcfg = dataclasses.replace(cfg, backend="pallas")
    _ts_solve(tx, w, h, dataclasses.replace(tcfg, max_iter=2))
    tiled, t_secs = _ts_solve(tx, w, h, tcfg)
    t_rel = abs(float(res.cost) - float(tiled.cost)) / abs(float(tiled.cost))
    out["sparse"] = {"nnz": nnz, "its": [SPARSE_ITERS / secs, SPARSE_ITERS / secs2],
                     "tiled_its": SPARSE_ITERS / t_secs, "dense_its": SPARSE_ITERS / d_secs,
                     "cost_rel_dense": c_rel, "w_rel_dense": w_rel, "h_rel_dense": h_rel,
                     "cost_rel_tiled": t_rel, "peak_bytes": peak, "dense_x_bytes": x.nbytes}
    print(f"[{card}] sparse: 0 kernel launches, cost {float(res.cost)}, history {hist.tolist()}, "
          f"bitwise on rerun; vs the dense clamp_inputs=False solve: cost rel {c_rel}, W {w_rel}, "
          f"H {h_rel} (relative Frobenius; limit {SPARSE_RTOL}); {SPARSE_ITERS / secs} and "
          f"{SPARSE_ITERS / secs2} it/s (host clock incl. the sort and upload) against the "
          f"tile-sparse solve's {SPARSE_ITERS / t_secs} (K5; cost rel {t_rel}) and the dense "
          f"solve's {SPARSE_ITERS / d_secs} (incl. the {x.nbytes / 1e6} MB X upload); peak device "
          f"memory {peak / 1e6} MB against dense X's {x.nbytes / 1e6} MB")


# phase 17: the shapes the H100 backend rule was derived from (bench.py:54-59,
# PERF.md section 4): label -> (M, K, N, matmul, X, state, members)
BACKEND_SHAPES = {
    **{f"{name} {pol}": (m, k, n, pol, "float32", "float32", 1)
       for name, (m, k, n) in (("paper", (512, 30, 3445)), ("ismir", (1025, 32, 4000)),
                               ("reference", (4096, 128, 350)), ("flagship", (10240, 256, 10240)))
       for pol in ("float32", "float32_fast", "bfloat16")},
    **{f"{name} {xd} X": (m, k, n, "float32", xd, "float32", 1)
       for name, (m, k, n) in (("reference", (4096, 128, 350)), ("flagship", (10240, 256, 10240)))
       for xd in ("bfloat16", "int8")},
    "streamed block float32": (1025, 32, 65408, "float32", "float32", "float32", 1),
    **{f"config 4 {pol}": (513, 32, 2000, pol, "float32", "float32", 128)
       for pol in ("float32", "bfloat16")},
    "select 16 float32": (512, 32, 1024, "float32", "float32", "float32", 16),
}
BACKEND_TILED_K = (128, 256, 384)       # tile-sparse 8192^2, 128^2 tiles at occupancy 0.08
BACKEND_ITERS = 4                       # each auto solve: iterations, a check every 2
BACKEND_AUTOTUNE = "ismir float32"      # the autotune cache check's shape


def _backend_cfg(shape):
    import nmf_tpu_torch as nt

    m, k, n, mm, xd, sd, members = shape
    return nt.SolveConfig(max_iter=BACKEND_ITERS, check_every=2,
                          precision=nt.Precision(matmul_dtype=mm, x_dtype=xd, state_dtype=sd))


def _record(card, out, label, times, rule):
    """One shape's samples, medians, winner and the rule's choice."""
    med = {b: statistics.median(v) for b, v in times.items()}
    winner = min(med, key=lambda b: (med[b], b != "pallas"))
    out["backend"]["measured"][label] = {"samples": times, "median": med, "winner": winner,
                                         "rule": rule}
    agree = "agrees" if winner == rule else "DISAGREES (one session: printed, not failed)"
    print(f"[{card}] backend {label}: kernels {med['pallas']} ms, plain {med['jnp']} ms a "
          f"step (median of {len(times['pallas'])} loops); faster: {winner}; the rule picks "
          f"{rule}: {agree}")


def _backend_measure(card, out):
    """(a) pick_backend's own measurement (``autotune._measure``) per shape,
    and K5 against the plain sweep per rank and policy."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.models import sparse_tiled as st
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts
    from nmf_tpu_torch.utils import autotune

    for label, shape in BACKEND_SHAPES.items():
        m, k, n, mm, xd, sd, members = shape
        t_p, t_j = autotune._measure(_backend_cfg(shape), m, k, n, members=members)
        rule = _auto_choice(_backend_cfg(shape), m, k, n, members)
        _record(card, out, label, {"pallas": t_p, "jnp": t_j}, rule)
        torch.cuda.empty_cache()
    m, n, _, t, occ, seed = TS_MAIN
    x, _, _ = tile_problem(m, 8, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    dev = torch.device("cuda")
    for k in BACKEND_TILED_K:
        _, w, h = tile_problem(m, k, n, t, occ, seed)
        for pol in ("float32", "float32_fast", "bfloat16"):
            cfg = nt.SolveConfig(precision=nt.Precision(pol))
            fns = {}
            for backend, route in (("pallas", "k5"), ("jnp", "plain")):
                c = dataclasses.replace(cfg, backend=backend)
                xarg, wd, hd, _ = st._prepare_tiled(tx, w, h, c, st._CHUNK, (t, t), dev)
                step, _ = st._tiled_fns(c, st._CHUNK, route)
                state = [wd, hd]

                def run(step=step, state=state, xarg=xarg):
                    state[0], state[1] = step(state[0], state[1], xarg)

                fns[backend] = run
            times = autotune.time_interleaved(fns)
            rule = "pallas" if ts.preferred(k, t, t, cfg.precision) else "jnp"
            _record(card, out, f"tiled K={k} {pol}", times, rule)
            del fns
            torch.cuda.empty_cache()


def _dense_problem(shape, seed=0):
    m, k, n, *_ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.rand(s, generator=g, device="cuda").clamp_min_(EPS)
                 for s in ((m, n), (m, k), (k, n)))


def _route_launches(choice, iters, checks, h_only=False):
    if choice != "pallas":
        return _launches()
    return _launches(update_h=iters, kl_cost=checks, **({} if h_only else {"update_w": iters}))


def _backend_auto_solves(card, out):
    """(b) auto solves whose K1/K2 launches follow the rule's choice, through
    each entry point that resolves it."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils import autotune

    it, checks = BACKEND_ITERS, BACKEND_ITERS // 2
    rec = {}

    def counted(entry, fn, choice, want, label):
        _reset_all()
        autotune.reset_counts()
        fn()
        torch.cuda.synchronize()
        got = dict(fused_mu.LAUNCHES)
        check(got == want and not any(fused_mu.PLAIN_CALLS.values()),
              f"backend auto {entry} {label}: launches {got}, expected {want} ({choice})")
        check(autotune.CHOICES.get((entry, choice), 0) >= 1,
              f"backend auto {entry} {label}: choices {dict(autotune.CHOICES)}, expected {choice}")
        rec[f"{entry} {label}"] = {"choice": choice, "launches": got}

    for label, shape in BACKEND_SHAPES.items():
        m, k, n, mm, xd, sd, members = shape
        cfg = _backend_cfg(shape)
        choice = _auto_choice(cfg, m, k, n, members)
        if members > 1 or label.startswith("streamed"):
            continue
        x, w, h = _dense_problem(shape)
        counted("solve", lambda: nt.solve(x, w, h, cfg, device="cuda"), choice,
                _route_launches(choice, it, checks), label)
        if xd == "float32" and mm == "float32":
            counted("semi", lambda: nt.solve_semi(x, w, h, cfg, n_frozen=2, device="cuda"), choice,
                    _route_launches(choice, it, checks), label)
            counted("h_only", lambda: nt.solve_h_only(x, w, h, cfg, device="cuda"), choice,
                    _route_launches(choice, it, checks, h_only=True), label)
        del x, w, h
        torch.cuda.empty_cache()
    # the streamed solve: full blocks of the streamed block's width and a ragged one
    m, k, bn = 1025, 32, 65408
    n = bn + 16384
    cfg = nt.SolveConfig(max_iter=2, check_every=2)
    choices = [_auto_choice(cfg, m, k, wd) for wd in (bn, n - bn)]
    g = torch.Generator(device="cuda").manual_seed(1)
    xs, ws, hs = (torch.rand(s, generator=g, device="cuda").clamp_min_(EPS).cpu().numpy()
                  for s in ((m, n), (m, k), (k, n)))
    _reset_all()
    autotune.reset_counts()
    nt.solve_out_of_core(xs, ws, hs, cfg, block_n=bn, device="cuda")
    torch.cuda.synchronize()
    got = dict(fused_mu.LAUNCHES)
    kern = sum(c == "pallas" for c in choices)
    want = _launches(update_h=2 * kern, update_w_numerator=2 * kern, kl_cost=kern)
    check(got == want and sum(autotune.CHOICES.values()) == 2,
          f"backend auto streamed: launches {got}, expected {want}; choices "
          f"{dict(autotune.CHOICES)} (widths {bn}, {n - bn}: {choices})")
    rec["streamed"] = {"choices": choices, "launches": got}
    del xs, ws, hs
    # the batched solve at config 4
    for pol in ("float32", "bfloat16"):
        b, m, k, n = 128, 513, 32, 2000
        cfg = nt.SolveConfig(max_iter=it, check_every=2, track_cost=False,
                             precision=nt.Precision(pol))
        choice = _auto_choice(cfg, m, k, n, b)
        g = torch.Generator(device="cuda").manual_seed(2)
        x, w, h = (torch.rand(s, generator=g, device="cuda").clamp_min_(EPS)
                   for s in ((b, m, n), (b, m, k), (b, k, n)))
        counted("batched", lambda: nt.solve_batched(x, w, h, cfg, device="cuda"), choice,
                _launches(update_h=it, update_w=it) if choice == "pallas" else _launches(),
                f"config 4 {pol}")
        del x, w, h
    # the tile-sparse solve at phase 8's layout: K5 where preferred holds
    from nmf_tpu_torch.ops.kernels import tile_sparse as ts

    m, n, k, t, occ, seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, seed)
    tx = nt.tiles_from_dense(x, (t, t))
    for pol in ("float32", "bfloat16"):
        cfg = nt.SolveConfig(max_iter=it, check_every=2, precision=nt.Precision(pol))
        pref = ts.preferred(k, t, t, cfg.precision)
        (_, _), k5, _, _ = _counted(lambda: _ts_solve(tx, w, h, cfg))
        want = {"h_numerator": it, "w_numerator": it} if pref else {"h_numerator": 0,
                                                                    "w_numerator": 0}
        check(k5 == want, f"backend auto tiled {pol}: K5 {k5}, expected {want}")
        rec[f"tiled {pol}"] = {"preferred": pref, "launches": k5}
    out["backend"]["auto"] = rec
    print(f"[{card}] backend: every auto solve launched what the rule chose: "
          f"{json.dumps({key: v.get('choice', v.get('choices', v.get('preferred'))) for key, v in rec.items()})}")


def _backend_autotune(card, out, tmp):
    """(c) backend="autotune" twice with a fresh cache file: the first call
    measures and writes the card's key, the second measures nothing."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.kernels import fused_mu
    from nmf_tpu_torch.utils import autotune

    shape = BACKEND_SHAPES[BACKEND_AUTOTUNE]
    m, k, n, *_ = shape
    cfg = dataclasses.replace(_backend_cfg(shape), backend="autotune")
    x, w, h = _dense_problem(shape)
    path = os.path.join(tmp, "autotune.json")
    old = os.environ.get(autotune._CACHE_ENV)
    os.environ[autotune._CACHE_ENV] = path
    try:
        autotune.clear_cache()
        runs = []
        for _ in range(2):
            autotune.reset_counts()
            _reset_all()
            nt.solve(x, w, h, cfg, device="cuda")
            torch.cuda.synchronize()
            runs.append((autotune.MEASURED["pick_backend"], dict(autotune.CHOICES),
                         dict(fused_mu.LAUNCHES)))
            autotune.clear_cache()      # the second call reads the file, as a new process would
        data = json.loads(pathlib.Path(path).read_text())
    finally:
        if old is None:
            os.environ.pop(autotune._CACHE_ENV, None)
        else:
            os.environ[autotune._CACHE_ENV] = old
    kind = torch.cuda.get_device_name(0)
    check(runs[0][0] == 1 and runs[1][0] == 0, f"autotune: measurements {runs[0][0]}, {runs[1][0]}")
    # the measurement's own kernel steps count as launches: warm-up and samples
    measure_steps = autotune._WARMUP + autotune._REPEATS * autotune._ITERS
    check(len(data) == 1 and next(iter(data)).startswith(kind + "|"),
          f"autotune: cache file {data} does not name {kind}")
    choice = next(iter(data.values()))
    for measured, choices, launches in runs:
        want = _route_launches(choice, BACKEND_ITERS, BACKEND_ITERS // 2)
        for key in ("update_h", "update_w"):
            want[key] += measured * measure_steps
        check(choices == {("solve", choice): 1} and launches == want,
              f"autotune: choices {choices}, launches {launches} for {choice}, expected {want}")
    out["backend"]["autotune"] = {"file": data, "measured": [r[0] for r in runs]}
    print(f"[{card}] backend autotune at {BACKEND_AUTOTUNE}: the first solve measured once and "
          f"wrote {data}; the second read it and measured nothing; both launched {choice}'s route")


def _backend_doctor(card, out):
    """(d) doctor --json's chip_spec names the card's row with both peaks."""
    from nmf_tpu_torch.utils.device import chip_spec_for

    proc = subprocess.run([sys.executable, "-m", "nmf_tpu_torch", "doctor", "--json"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"doctor: exit {proc.returncode}: {proc.stderr[-400:]}")
    cs = json.loads(proc.stdout)["chip_spec"]
    kind = torch.cuda.get_device_name(0)
    spec = chip_spec_for(kind)
    check(cs == {"device_kind": kind, "bf16_tflops": spec.peak_tflops("bfloat16"),
                 "f32_tflops": spec.peak_tflops("float32")}, f"doctor chip_spec: {cs}")
    if "H100 80GB HBM3" in kind:
        check(cs["bf16_tflops"] == 989.0 and cs["f32_tflops"] == 67.0, f"doctor chip_spec: {cs}")
    out["backend"]["doctor_chip_spec"] = cs
    print(f"[{card}] doctor --json chip_spec: {cs} (row {spec.family})")


def phase_backend(card, tmp, out, backend_out):
    print(f"[{card}] phase 17: the H100 backend rule: each shape measured as pick_backend "
          "measures it, auto solves through every entry point, autotune's cache, doctor")
    out["backend"] = {"measured": {}, "card": card}
    _backend_measure(card, out)
    if backend_out:
        os.makedirs(os.path.dirname(os.path.abspath(backend_out)), exist_ok=True)
        pathlib.Path(backend_out).write_text(json.dumps(
            {"card": card, "measured": out["backend"]["measured"]}, indent=1))
        print(f"[{card}] backend samples written to {backend_out}")
    _backend_auto_solves(card, out)
    _backend_autotune(card, out, tmp)
    _backend_doctor(card, out)


# phase 18: the mesh (ROADMAP.md Queue 1 step 12a)
MESH_ITERS = 200                       # the reference pipeline's
MESH_FLAGSHIP = (10240, 256, 10240)    # (M, K, N), 50 iterations
MESH_FLAGSHIP_ITERS = 50
MESH_RANK_SECONDS = 300                # each spawned rank's wall-clock limit
MESH_BLOCK = (2048, 175, 128)          # (M, N, K) of a rank's block of the 2x2 reference


def _mesh_reference():
    import nmf_tpu_torch as nt

    fx = nt.fixtures
    x, w, h = (fx.as_seen_by_solver(a) for a in fx.reference_fixture_arrays().values())
    return x, w, h, dataclasses.replace(nt.reference_preset(), backend="pallas")


def _mesh_counted(fn):
    """(fn(), host seconds, every count), the counts set to 0 just before."""
    _reset_all()
    res, secs = _timed(fn)
    return res, secs, _all_counts()


def _numerator_launches(iters):
    return {**_launches(update_h_numerator=iters, update_w_numerator=iters),
            **{k: 0 for k in _all_counts() if k not in _launches()}}


def _mesh_rank_main(rank: int, d: str) -> int:
    """One of phase 18c's four ranks on ``cuda:0`` over gloo (``chip_smoke.py
    --mesh-rank R --mesh-dir D``): the reference pipeline on a 2x2 mesh
    through K1/K2 ``numerator_only`` twice, then on the plain route
    (``backend="jnp"``), then int8 X under ``auto``; its counts to
    ``D/rank<R>.json``, rank 0's gathered factors to ``D/mesh.npz``."""
    import torch.distributed as dist

    import nmf_tpu_torch as nt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank, world_size=4)
    mesh = nt.make_mesh((2, 2), device="cuda")
    x, w, h, cfg = _mesh_reference()
    rec, full = {}, []
    for tag in ("first", "rerun"):
        res, secs, counts = _mesh_counted(lambda: nt.solve_sharded(x, w, h, cfg, mesh=mesh))
        rec[tag] = {"counts": counts, "seconds": secs, "cost": float(res.cost)}
        full.append(nt.gather_result(res, mesh))
    rec["bitwise"] = all(torch.equal(_bits(getattr(full[0], f)), _bits(getattr(full[1], f)))
                         for f in ("w", "h", "cost_history"))
    cfgp = dataclasses.replace(cfg, backend="jnp")
    resp, secsp, countsp = _mesh_counted(lambda: nt.solve_sharded(x, w, h, cfgp, mesh=mesh))
    rec["plain"] = {"counts": countsp, "seconds": secsp, "cost": float(resp.cost)}
    plain = nt.gather_result(resp, mesh)
    cfg8 = dataclasses.replace(cfg, backend="auto", precision=nt.Precision(x_dtype="int8"))
    res8, secs8, counts8 = _mesh_counted(lambda: nt.solve_sharded(x, w, h, cfg8, mesh=mesh))
    rec["int8"] = {"counts": counts8, "seconds": secs8, "cost": float(res8.cost)}
    if rank == 0:
        np.savez(os.path.join(d, "mesh.npz"), w=full[0].w.cpu().numpy(),
                 h=full[0].h.cpu().numpy(), hist=full[0].cost_history.cpu().numpy(),
                 wp=plain.w.cpu().numpy(), hp=plain.h.cpu().numpy())
    pathlib.Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    from nmf_tpu_torch.parallel.mesh import shutdown

    shutdown()
    return 0


def _mesh_1x1(card, out, mesh, ref, ref_secs):
    """(a) the reference pipeline on the in-process 1x1 NCCL mesh."""
    import nmf_tpu_torch as nt

    x, w, h, cfg = _mesh_reference()
    where = "mesh 1x1 reference"
    solve = lambda: nt.solve_sharded(x, w, h, cfg, mesh=mesh)   # noqa: E731
    res, secs, counts = _mesh_counted(solve)
    want = _numerator_launches(MESH_ITERS)
    check(counts == want, f"{where}: counts {counts}, expected {want}")
    out["launches"][where] = counts
    cost = float(res.cost)
    pin = abs(cost - PIN_COST) / PIN_COST
    check(pin <= 1e-4, f"{where}: cost {cost} vs the pin {PIN_COST}: rel {pin}")
    again = solve()
    for f in ("w", "h", "cost_history"):
        check(torch.equal(_bits(getattr(res, f)), _bits(getattr(again, f))),
              f"{where}: {f} differs on a rerun")
    full = nt.gather_result(res, mesh)
    rel = abs(cost - float(ref.cost)) / abs(float(ref.cost))
    fro = (_rel_fro(full.w, ref.w), _rel_fro(full.h, ref.h))
    check(rel <= 1e-5 and max(fro) <= 1e-4,
          f"{where}: cost rel {rel}, W/H rel Frobenius {fro} to the single-device solve")
    # it/s in turns: mesh, single, single, mesh, twice
    secs_m, secs_s = [secs], [ref_secs]
    for _ in range(2):
        secs_m.append(_timed(solve)[1])
        secs_s.append(_timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))[1])
        secs_s.append(_timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))[1])
        secs_m.append(_timed(solve)[1])
    its_m = [MESH_ITERS / s for s in secs_m]
    its_s = [MESH_ITERS / s for s in secs_s]
    # kernels a step and the device's busy share of each (torch.profiler)
    from torch.profiler import ProfilerActivity, profile

    prof_rec = {}
    for key, fn in (("mesh", solve), ("single", lambda: nt.solve(x, w, h, cfg, device="cuda"))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, s = _timed(fn)
        with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            dev = _device_shares(trace)
            events = json.loads(pathlib.Path(trace).read_text())["traceEvents"]
        kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
        prof_rec[key] = {"kernels_per_iter": kernels / MESH_ITERS, "busy": dev["busy"] / s,
                         "kernels_ms": 1e3 * dev["kernels"], "wall_ms": 1e3 * s}
    # what four NCCL all-reduces of one KL step would cost here (the 1x1
    # mesh skips its one-rank sums, as XLA drops a psum over one device)
    import torch.distributed as dist

    k, n, m = 128, 350, 4096
    bufs = [torch.ones(s, device="cuda") for s in ((k, n), (k,), (m, k), (k,))]
    for b in bufs:
        dist.all_reduce(b)
    torch.cuda.synchronize()
    reps = 100
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        for b in bufs:
            dist.all_reduce(b)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / reps
    out["mesh"]["1x1"] = {
        "cost": cost, "pin_rel": pin, "cost_rel_single": rel, "fro_w_h": fro,
        "launches": counts, "its_mesh": its_m, "its_single": its_s, "profile": prof_rec,
        "nccl_4_allreduce_ms": {"device": dev_ms, "host": host_ms}, "card": card}
    print(f"[{card}] 18a mesh 1x1 (NCCL, in-process) reference, backend pallas: K1/K2 "
          f"numerator_only {counts['update_h_numerator']}/{counts['update_w_numerator']}, full "
          f"K1/K2 {counts['update_h']}/{counts['update_w']}, K3 {counts['kl_cost']}; cost {cost} "
          f"(rel {pin} to the pin; {rel} to the single-device solve; W/H rel Frobenius {fro}); "
          f"bitwise rerun; it/s mesh {its_m} against single-device {its_s}; profiled: "
          f"{json.dumps(prof_rec)}; four NCCL "
          f"all-reduces of a step's sizes on one rank: {dev_ms} ms device, {host_ms} ms host")


def _mesh_flagship(card, out, mesh):
    """(b) the flagship on the 1x1 mesh under auto: the rule's route at the
    local shape, it/s beside the single-device solve's."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.utils import autotune

    m, k, n = MESH_FLAGSHIP
    x, w, h = _dense_problem((m, k, n))
    rec = {}
    for pol in ("float32", "bfloat16"):
        where = f"mesh 1x1 flagship {pol}"
        cfg = nt.SolveConfig(max_iter=MESH_FLAGSHIP_ITERS, check_every=25,
                             precision=nt.Precision(pol))
        choice = autotune.rule_pick(m, k, n, pol, "float32", "float32")
        autotune.reset_counts()
        res, secs, counts = _mesh_counted(lambda: nt.solve_sharded(x, w, h, cfg, mesh=mesh))
        it = MESH_FLAGSHIP_ITERS
        want = _numerator_launches(it if choice == "pallas" else 0)
        check(counts == want, f"{where}: counts {counts}, expected {want} ({choice})")
        check(dict(autotune.CHOICES) == {("sharded", choice): 1},
              f"{where}: choices {dict(autotune.CHOICES)}, expected sharded {choice}")
        out["launches"][where] = counts
        single, s_secs = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))
        rel = abs(float(res.cost) - float(single.cost)) / abs(float(single.cost))
        check(rel <= 1e-5, f"{where}: cost {float(res.cost)} vs the single-device solve "
              f"{float(single.cost)}: rel {rel} (limit 1e-5)")
        secs_m, secs_s = [secs], [s_secs]
        secs_s.append(_timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))[1])
        secs_m.append(_timed(lambda: nt.solve_sharded(x, w, h, cfg, mesh=mesh))[1])
        rec[pol] = {"choice": choice, "launches": counts, "cost_rel_single": rel,
                    "its_mesh": [it / s for s in secs_m], "its_single": [it / s for s in secs_s]}
        print(f"[{card}] 18b {where}: rule_pick at the local shape {m}x{n}x{k} = {choice}; "
              f"K1/K2 numerator_only {counts['update_h_numerator']}/"
              f"{counts['update_w_numerator']}; cost rel {rel} to the single-device solve; it/s "
              f"mesh {rec[pol]['its_mesh']} against single-device {rec[pol]['its_single']}")
    out["mesh"]["flagship"] = rec
    del x, w, h
    torch.cuda.empty_cache()


def _mesh_2x2(card, out, ref, ref8):
    """(c) four spawned ranks on the one card over gloo, 2x2."""
    with tempfile.TemporaryDirectory(prefix="nmf_mesh_") as d:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
        logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(4)]
        procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--mesh-rank",
                                   str(r), "--mesh-dir", d], stdout=logs[r],
                                  stderr=subprocess.STDOUT, env=env) for r in range(4)]
        t0 = time.perf_counter()
        deadline = t0 + MESH_RANK_SECONDS
        failed = None
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if time.perf_counter() > deadline:
                failed = "timeout"
            time.sleep(0.1)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        wall = time.perf_counter() - t0
        if failed is not None:
            r = 0 if failed == "timeout" else failed
            tail = pathlib.Path(d, f"rank{r}.log").read_text()[-3000:]
            check(False, f"18c: rank group failed ({failed}):\n{tail}")
        recs = [json.loads(pathlib.Path(d, f"rank{r}.json").read_text()) for r in range(4)]
        got = np.load(os.path.join(d, "mesh.npz"))
        w2, h2, wp, hp = (torch.from_numpy(got[k]).cuda() for k in ("w", "h", "wp", "hp"))
    want = _numerator_launches(MESH_ITERS)
    for r, rec in enumerate(recs):
        for tag in ("first", "rerun"):
            check(rec[tag]["counts"] == want,
                  f"18c rank {r} {tag}: counts {rec[tag]['counts']}, expected {want}")
        check(rec["bitwise"], f"18c rank {r}: the rerun's gathered bits differ")
        i8 = rec["int8"]["counts"]
        check(not any(i8.values()), f"18c rank {r}: int8 X under auto launched {i8}")
        check(not any(rec["plain"]["counts"].values()),
              f"18c rank {r}: the plain route launched {rec['plain']['counts']}")
    costs = {rec[t]["cost"] for rec in recs for t in ("first", "rerun")}
    check(len(costs) == 1, f"18c: costs differ across ranks or runs: {costs}")
    cost = costs.pop()
    rel = abs(cost - float(ref.cost)) / abs(float(ref.cost))
    pin = abs(cost - PIN_COST) / PIN_COST
    fro = (_rel_fro(w2, ref.w), _rel_fro(h2, ref.h))
    check(rel <= 1e-5 and pin <= 1e-4 and max(fro) <= 1e-4,
          f"18c: cost {cost} rel {rel} to the single-device solve ({pin} to the pin), W/H rel "
          f"Frobenius {fro}")
    # the same mesh on the plain route: a reference that runs no kernel at
    # the 2048 x 175 blocks
    p_costs = {rec["plain"]["cost"] for rec in recs}
    check(len(p_costs) == 1, f"18c plain: costs differ across ranks: {p_costs}")
    p_cost = p_costs.pop()
    p_rel = abs(cost - p_cost) / abs(p_cost)
    p_fro = (_rel_fro(w2, wp), _rel_fro(h2, hp))
    check(p_rel <= 1e-5 and max(p_fro) <= 1e-4,
          f"18c: cost {cost} rel {p_rel} to the plain-route 2x2 solve's {p_cost}, W/H rel "
          f"Frobenius {p_fro}")
    i8_costs = {rec["int8"]["cost"] for rec in recs}
    check(len(i8_costs) == 1, f"18c int8: costs differ across ranks: {i8_costs}")
    i8_cost = i8_costs.pop()
    i8_rel = abs(i8_cost - float(ref8.cost)) / abs(float(ref8.cost))
    check(i8_rel <= 1e-5, f"18c int8: cost {i8_cost}, rel {i8_rel} to the single-device plain "
          f"int8 solve's {float(ref8.cost)}")
    secs = [max(rec[t]["seconds"] for rec in recs) for t in ("first", "rerun")]
    out["launches"]["mesh 2x2 reference"] = recs[0]["first"]["counts"]
    out["mesh"]["2x2"] = {
        "cost": cost, "cost_rel_single": rel, "pin_rel": pin, "fro_w_h": fro,
        "cost_rel_plain_mesh": p_rel, "fro_w_h_plain_mesh": p_fro,
        "rank_launches": [rec["first"]["counts"] for rec in recs],
        "its": [MESH_ITERS / s for s in secs], "int8_cost": i8_cost, "int8_rel_single": i8_rel,
        "int8_launches": recs[0]["int8"]["counts"], "wall_s": wall, "card": card}
    print(f"[{card}] 18c mesh 2x2, four ranks on cuda:0 over gloo, reference, backend pallas: "
          f"every rank K1/K2 numerator_only {MESH_ITERS}/{MESH_ITERS}, no other launch; cost "
          f"{cost} (rel {rel} to the single-device solve, {pin} to the pin), W/H rel Frobenius "
          f"{fro}; against the plain-route 2x2 solve: cost rel {p_rel}, W/H rel Frobenius "
          f"{p_fro}; rerun bitwise on every rank; {out['mesh']['2x2']['its']} it/s (gloo stages "
          f"each sum through the host); int8 X under auto: no launch (plain route), cost "
          f"{i8_cost} (rel {i8_rel} to the single-device plain int8 solve); {wall} s for the four "
          "processes")


def _mesh_cli(card, out, tmp, mesh_w):
    """(d) run --mesh 1x1 under torch.distributed.run."""
    import nmf_tpu_torch as nt

    nt.fixtures.write_reference_fixtures(tmp)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
           "-m", "nmf_tpu_torch", "run", "X.bin", "W.bin", "H.bin", "-o", "Wm.bin", "Hm.bin",
           "--mesh", "1x1", "--jsonl", "mesh.jsonl"]
    proc = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"18d: {' '.join(cmd[2:])}: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rec = json.loads(pathlib.Path(tmp, "mesh.jsonl").read_text().splitlines()[-1])
    pin = abs(rec["final_cost"] - PIN_COST) / PIN_COST
    check(rec["iterations"] == MESH_ITERS and pin <= 1e-4,
          f"18d: {rec['iterations']} iterations, final cost {rec['final_cost']}: rel {pin}")
    w_file = nt.read_matrix(os.path.join(tmp, "Wm.bin"))
    same = w_file.tobytes() == mesh_w.cpu().numpy().tobytes()
    check(same, "18d: Wm.bin differs from the in-process 1x1 mesh solve's W")
    out["mesh"]["cli"] = {"final_cost": rec["final_cost"], "pin_rel": pin,
                          "iters_per_sec": rec["iters_per_sec"]}
    print(f"[{card}] 18d torch.distributed.run --nproc-per-node 1 ... run --mesh 1x1: "
          f"{rec['iterations']} iterations, final cost {rec['final_cost']} (rel {pin} to the "
          f"pin), Wm.bin byte-equal to the in-process mesh solve's W; {rec['iters_per_sec']} it/s")


def _hold_numerators(card, rec, label, w, h, x, prec, limits, control=None):
    """K1/K2 ``numerator_only`` against ``mu.numerator_h``/``numerator_w``
    on the same operands, as phase 9a holds them: f32, finite, bitwise on a
    rerun, the max and RMS relative errors within ``limits`` and, given a
    ``control`` policy, the control's RMS outside the limit."""
    max_limit, spread_limit, _ = limits
    controls = _num_pairs(control) if control else {}
    m, k = w.shape
    n = h.shape[1]
    for name, (kern, plain) in _num_pairs(prec).items():
        where = _where(f"{name} numerator_only", w, h, f"[{label}] ")
        res, ref = _run_pair(kern, plain, w, h, x, where)
        check(res.dtype == torch.float32
              and tuple(res.shape) == ((k, n) if name == "update_h" else (m, k)),
              f"18e {where}: {res.dtype} {tuple(res.shape)}")
        err, spread, _ = _mode_err(res, ref)
        what = (f"max rel err {err} (limit {max_limit}), rms rel err {spread} (limit "
                f"{spread_limit})")
        check((max_limit is None or err <= max_limit)
              and (spread_limit is None or spread <= spread_limit), f"18e {where}: {what}")
        entry = {"max_rel_err": err, "rms_rel_err": spread,
                 "max_abs_err": float((res - ref).abs().max())}
        if control:
            c_spread = _mode_err(controls[name][0](w, h, x), ref)[1]
            check(c_spread > spread_limit, f"18e {where}: the control ({control.matmul_dtype} "
                  f"GEMMs) reads {c_spread}, within the limit {spread_limit}")
            entry["control_rms"] = c_spread
            what += f"; control ({control.matmul_dtype} GEMMs) {c_spread}"
        rec[f"{label} {name}"] = entry
        print(f"[{card}] 18e {where}: {what}, bitwise-repeatable")
        del res, ref


def _mesh_numerators(card, out):
    """(e) K1/K2 ``numerator_only`` at the shapes the mesh path gives them,
    against their plain versions: a rank's block of (c) and a rank's piece
    of (g)'s streamed 1x4 block, each in every mode of phase 9a (its
    operands, limits and controls) and on its problem's four real blocks at
    f32, and (b)'s bfloat16 flagship on phase 7's exposed operands (with
    the f32-GEMM control) and on (b)'s own."""
    rec = out["mesh"]["numerators"] = {}
    m, n, k = MESH_BLOCK
    for mode, spec in _num_modes().items():
        w, h, x = _num_operands(m, n, k, mode, spec)
        _hold_numerators(card, rec, f"block {mode}", w, h, x, spec.prec, spec.limits,
                         spec.control)
    x, w, h, _ = _mesh_reference()
    f32 = _num_modes()["float32"]
    for r in range(2):
        for c in range(2):
            blk = (w[r * m:(r + 1) * m], h[:, c * n:(c + 1) * n],
                   x[r * m:(r + 1) * m, c * n:(c + 1) * n])
            wb, hb, xb = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
                          for a in blk)
            _hold_numerators(card, rec, f"reference block ({r}, {c})", wb, hb, xb, f32.prec,
                             f32.limits)
    # (g)'s streamed 1x4 mesh: each rank's (M, bn / 4) piece of the one block
    pm, pn, pk = MP_OOC[0], MP_OOC[1] // 4, MP_OOC[2]
    for mode, spec in _num_modes().items():
        w, h, x = _num_operands(pm, pn, pk, mode, spec)
        _hold_numerators(card, rec, f"streamed piece {mode}", w, h, x, spec.prec, spec.limits,
                         spec.control)
    x, w, h = _mp_stream_problem(0)
    for c in range(4):
        piece = (w, h[:, c * pn:(c + 1) * pn], x[:, c * pn:(c + 1) * pn])
        wb, hb, xb = (torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in piece)
        _hold_numerators(card, rec, f"streamed piece (0, {c})", wb, hb, xb, f32.prec, f32.limits)
    del x, w, h, wb, hb, xb
    fm, fk, fn = MESH_FLAGSHIP
    spec = _modes()["bfloat16"]
    w, h, x = _walk_operands(fm, fn, fk, "bfloat16", spec)
    _hold_numerators(card, rec, "bfloat16 flagship, exposed", w, h, x, spec.prec, spec.limits,
                     spec.control)
    del w, h, x
    x, w, h = _dense_problem((fm, fk, fn))
    _hold_numerators(card, rec, "bfloat16 flagship, (b)'s operands", w, h, x, spec.prec,
                     spec.limits)
    del w, h, x
    torch.cuda.empty_cache()


MP_OOC = (1025, 65_408, 32)           # (M, N, K): phase 15's streamed block as a whole X
MP_OOC_ITERS, MP_OOC_CHECK = 50, 25   # 100, 50 before phase 20 came (the 1200 s limit)
MP_TR_BLOCK, MP_TR_ITERS = 16_384, 50
MP_TILED_ITERS = 50
MP_TILED_RTOL = 1e-4                  # K5 against the plain sweep: phase 8's f32 limit
MP_ONLINE_BLOCK, MP_ONLINE_INNER = 4096, 20
MP_CKPT_EVERY = 50
MP_COST_RTOL, MP_FRO = 1e-5, 1e-4     # cost relative, W / H relative Frobenius
MP_RANK_SECONDS = 420                 # 18g's four ranks' wall-clock limit
MP_CLI_FRO = 1e-5                     # a CLI run's files against the same call in process


def _mp_stream_problem(seed):
    """(X, W0, H0) of the streamed mesh runs, made on the host from ``seed``."""
    m, n, k = MP_OOC
    rng = np.random.RandomState(seed + 180)
    return (rng.rand(m, n).astype(np.float32), rng.rand(m, k).astype(np.float32),
            rng.rand(k, n).astype(np.float32))


def _mp_configs():
    import nmf_tpu_torch as nt

    return {
        "stream": nt.SolveConfig(max_iter=MP_OOC_ITERS, check_every=MP_OOC_CHECK,
                                 backend="pallas"),
        "transform": nt.SolveConfig(max_iter=MP_TR_ITERS, check_every=25),
        "online": nt.SolveConfig(max_iter=MP_ONLINE_INNER),
        "tiled": nt.SolveConfig(max_iter=MP_TILED_ITERS, check_every=25),
        "batched": nt.SolveConfig(max_iter=BATCH_ITERS, check_every=25, track_cost=False,
                                  backend="pallas"),
        "restarts": nt.SolveConfig(max_iter=SEL_ITERS, check_every=25, backend="pallas"),
        "reference": dataclasses.replace(nt.reference_preset(), backend="pallas"),
    }


def _mp_batch(seed):
    b, m, n, k = BATCH_SHAPE
    rng = np.random.RandomState(seed + 181)
    return tuple(np.maximum(rng.rand(*s).astype(np.float32), np.float32(EPS))
                 for s in ((b, m, n), (b, m, k), (b, k, n)))


def _mp_tiled():
    import nmf_tpu_torch as nt

    m, n, k, t, occ, ts_seed = TS_MAIN
    x, w, h = tile_problem(m, k, n, t, occ, ts_seed)
    return nt.tiles_from_dense(x, (t, t)), w, h


def _mp_tiled_split(tx, w, h, cfg, mesh):
    """(prepare seconds, loop seconds) of one tiled solve, single-device
    for ``mesh`` None: ``_prepare_tiled`` (the rank's tiles, the plans,
    the uploads), then ``_run_tiled`` (the checked loop)."""
    from nmf_tpu_torch.models import sparse_tiled as st

    dev = None if mesh is not None else torch.device(DEVICE)
    (xarg, wp, hp, info), prep = _timed(lambda: st._prepare_tiled(
        tx, w, h, cfg, st._CHUNK, tx.tile_shape, dev, mesh=mesh))
    return prep, _timed(lambda: st._run_tiled(xarg, wp, hp, cfg, info))[1]


def _mp_psum_us(mesh, k, calls=2000):
    """Host microseconds of one ``psum`` of a K-vector over 'mr' on the 1x1
    mesh, where it makes no call."""
    from nmf_tpu_torch.parallel.mesh import ROW_AXIS, psum

    t = torch.zeros(k, device=DEVICE)
    t0 = time.perf_counter()
    for _ in range(calls):
        psum(t, mesh, ROW_AXIS)
    return (time.perf_counter() - t0) / calls * 1e6


def _mp_counts(fn):
    """(fn(), host seconds, every kernel count): the counts set to 0 just
    before ``fn`` and read just after."""
    _reset_all()
    res, secs = _timed(fn)
    return res, secs, _all_counts()


def _mp_want(**counts):
    """Every count (``_all_counts``' keys), 0 unless given."""
    return {key: counts.get(key, 0) for key in _all_counts()}


def _mp_stream_want():
    """K1/K2 ``numerator_only`` on every rank's piece of the one block, an
    iteration; the cost plain (``kl_partial``), as in JAX."""
    return _mp_want(update_h_numerator=MP_OOC_ITERS, update_w_numerator=MP_OOC_ITERS)


def _mp_tiled_want(k5: bool):
    n = MP_TILED_ITERS if k5 else 0
    return _mp_want(**{"K5 h_numerator": n, "K5 w_numerator": n})


def _mp_batched_want():
    """K1-K3 over a rank's members: one launch a call, whatever its members;
    config 4 tracks no cost."""
    return _mp_want(update_h=BATCH_ITERS, update_w=BATCH_ITERS)


def _mp_restarts_want():
    return _mp_want(update_h=SEL_ITERS, update_w=SEL_ITERS, kl_cost=SEL_ITERS // 25)


def _mp_rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _mp_fro(a, b):
    a, b = (torch.as_tensor(np.asarray(v.cpu() if torch.is_tensor(v) else v)) for v in (a, b))
    return _rel_fro(a, b)


def _mp_hold(where, cost, cost_ref, pairs, cost_rtol=MP_COST_RTOL):
    """Check a result against its twin: cost relative, factors relative
    Frobenius; returns the numbers."""
    rel = _mp_rel(cost, cost_ref)
    fro = [_mp_fro(a, b) for a, b in pairs]
    check(rel <= cost_rtol and max(fro, default=0.0) <= MP_FRO,
          f"{where}: cost rel {rel} (limit {cost_rtol}), rel Frobenius {fro} (limit {MP_FRO})")
    return {"cost_rel": rel, "fro": fro}


def _mp_state_bits(a, b) -> bool:
    return all(np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes()
               for f in ("w", "h", "iteration")) and list(a.cost_history) == list(b.cost_history)


def _mp_ckpt(mesh, x, w, h, cfg, d, sharded):
    """The checkpointed reference solve on ``mesh``: uninterrupted, and
    stopped at half and resumed; (state, resumed-equals-uninterrupted)."""
    from nmf_tpu_torch.utils.checkpoint import solve_with_checkpoints

    whole = solve_with_checkpoints(x, w, h, cfg, os.path.join(d, "whole"), every=MP_CKPT_EVERY,
                                   mesh=mesh, sharded_checkpoints=sharded)
    half = dataclasses.replace(cfg, max_iter=cfg.max_iter // 2)
    solve_with_checkpoints(x, w, h, half, os.path.join(d, "parts"), every=MP_CKPT_EVERY,
                           mesh=mesh, sharded_checkpoints=sharded)
    again = solve_with_checkpoints(x, w, h, cfg, os.path.join(d, "parts"), every=MP_CKPT_EVERY,
                                   mesh=mesh, sharded_checkpoints=sharded)
    return whole, _mp_state_bits(again, whole)


def _mp_paths_rank_main(rank: int, d: str) -> int:
    """One of 18g's four ranks on ``cuda:0`` over gloo (``chip_smoke.py
    --mesh-paths-rank R --mesh-dir D``): on a 1x4 mesh the streamed solve
    (K1/K2 ``numerator_only``), its transform and the online learner; on a
    2x2 mesh the tiled solve under ``auto`` (K5) and on the plain sweeps,
    config 4's batch (K1-K3, 32 members a rank), the R = 16 restarts (8
    members a rank over 'mr') and the checkpointed reference solve,
    gathered and sharded.  Its counts to ``D/rank<R>.json``; rank 0's
    results to ``D/paths.npz``.  The rank leaves through
    ``parallel.mesh.shutdown`` and exits normally."""
    import torch.distributed as dist

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import BOTH, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank, world_size=4)
    cfgs = _mp_configs()
    rec, arrays = {}, {}
    row = nt.make_mesh((1, 4), device=DEVICE)
    x, w, h = _mp_stream_problem(0)
    res, secs, counts = _mp_counts(lambda: nt.solve_out_of_core(
        x, w, h, cfgs["stream"], block_n=MP_OOC[1], mesh=row))
    rec["stream"] = {"counts": counts, "seconds": secs, "cost": float(res.cost)}
    arrays.update(stream_w=res.w.cpu().numpy(), stream_h=res.h.cpu().numpy())
    tr, secs, _ = _mp_counts(lambda: nt.transform_out_of_core(
        x, w, config=cfgs["transform"], block_n=MP_TR_BLOCK, mesh=row))
    rec["transform"] = {"seconds": secs, "cost": float(tr.cost)}
    arrays["transform_h"] = tr.h
    on, secs, counts = _mp_counts(lambda: nt.solve_online(
        x, w, cfgs["online"], block_n=MP_ONLINE_BLOCK, inner_iters=MP_ONLINE_INNER, mesh=row))
    rec["online"] = {"counts": counts, "seconds": secs}
    arrays.update(online_w=on.w, online_curve=on.learning_curve)
    del x, w, h
    grid = nt.make_mesh((2, 2), device=DEVICE)
    tx, w, h = _mp_tiled()
    for backend in ("auto", "jnp"):
        cfg = dataclasses.replace(cfgs["tiled"], backend=backend)
        res, secs, counts = _mp_counts(lambda: nt.solve_sparse_tiled(tx, w, h, cfg, mesh=grid))
        full = nt.gather_result(res, grid)
        rec[f"tiled {backend}"] = {"counts": counts, "seconds": secs, "cost": float(res.cost)}
        arrays.update({f"tiled_{backend}_w": full.w.cpu().numpy(),
                       f"tiled_{backend}_h": full.h.cpu().numpy()})
    del tx, w, h
    xs, ws, hs = _mp_batch(0)
    res, secs, counts = _mp_counts(lambda: nt.solve_batched(xs, ws, hs, cfgs["batched"],
                                                            mesh=grid))
    full = nt.gather_result(res, grid, w_spec=(BOTH, None, None), h_spec=(BOTH, None, None))
    rec["batched"] = {"counts": counts, "seconds": secs, "members": int(res.w.shape[0]),
                      "iterations": res.iterations.tolist()}
    arrays.update(batched_w=full.w.cpu().numpy(), batched_h=full.h.cpu().numpy())
    del xs, ws, hs, res, full
    xsel = _sel_problem(0)
    sel, secs, counts = _mp_counts(lambda: nt.solve_restarts(
        xsel, rank=SEL_SHAPE[2], n_restarts=SEL_RESTARTS, config=cfgs["restarts"], seed=0,
        mesh=grid))
    rec["restarts"] = {"counts": counts, "seconds": secs, "costs": sel.costs.tolist(),
                       "best": sel.best_index}
    x, w, h, _ = _mesh_reference()
    for sharded in (False, True):
        tag = "sharded" if sharded else "gathered"
        cd = os.path.join(d, f"ckpt_{tag}")
        (state, bits), secs, _ = _mp_counts(lambda: _mp_ckpt(grid, x, w, h, cfgs["reference"],
                                                             cd, sharded))
        rec[f"ckpt {tag}"] = {"seconds": secs, "bitwise": bits, "cost": state.cost_history[-1]}
        if not sharded:
            arrays.update(ckpt_w=state.w, ckpt_h=state.h)
    if rank == 0:
        np.savez(os.path.join(d, "paths.npz"), **arrays)
    pathlib.Path(d, f"rank{rank}.json").write_text(json.dumps(rec))
    shutdown()
    return 0


def _mp_spawn(d: str, flag: str, seconds: float):
    """Four ``chip_smoke.py`` ranks with ``flag`` on the card; (wall
    seconds, each rank's record), or a failed check with the tail of the
    first failing rank's log."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    logs = [open(os.path.join(d, f"rank{r}.log"), "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), flag, str(r),
                               "--mesh-dir", d], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env) for r in range(4)]
    t0 = time.perf_counter()
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
        if time.perf_counter() > t0 + seconds:
            failed = "timeout"
        time.sleep(0.1)
    if failed is None:
        failed = next((r for r, p in enumerate(procs) if p.returncode != 0), None)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()
    wall = time.perf_counter() - t0
    if failed is not None:
        r = 0 if failed == "timeout" else failed
        tail = pathlib.Path(d, f"rank{r}.log").read_text()[-3000:]
        check(False, f"{flag}: rank group failed ({failed}):\n{tail}")
    return wall, [json.loads(pathlib.Path(d, f"rank{r}.json").read_text()) for r in range(4)]


def _mp_turns(mesh_fn, single_fn, iters):
    """it/s of the mesh and the single-device run in turns: mesh, single,
    single, mesh."""
    secs_m, secs_s = [], []
    for fn, acc in ((mesh_fn, secs_m), (single_fn, secs_s), (single_fn, secs_s),
                    (mesh_fn, secs_m)):
        acc.append(_timed(fn)[1])
    return [iters / s for s in secs_m], [iters / s for s in secs_s]


def _mp_1x1(card, out, tmp):
    """(f) every new mesh path on the in-process 1x1 NCCL mesh, each against
    its single-device twin; returns the twins 18g is held to."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import BOTH

    cfgs = _mp_configs()
    mesh = nt.make_mesh((1, 1), device=DEVICE)
    rec = out["mesh"]["paths"] = {"card": card}
    twins = {}
    x, w, h = _mp_stream_problem(0)
    bn = MP_OOC[1]
    mesh_fn = lambda: nt.solve_out_of_core(x, w, h, cfgs["stream"], block_n=bn, mesh=mesh)  # noqa: E731
    single_fn = lambda: nt.solve_out_of_core(x, w, h, cfgs["stream"], block_n=bn,  # noqa: E731
                                             device=DEVICE)
    res, secs, counts = _mp_counts(mesh_fn)
    want = _mp_stream_want()
    check(counts == want, f"18f streamed 1x1: counts {counts}, expected {want}")
    out["launches"]["mesh paths 1x1 streamed"] = counts
    single, s_secs = _timed(single_fn)
    twins["stream"] = single
    held = _mp_hold("18f streamed 1x1", res.cost, single.cost,
                    [(res.w, single.w), (res.h, single.h)])
    its_m, its_s = _mp_turns(mesh_fn, single_fn, MP_OOC_ITERS)
    rec["streamed 1x1"] = {"launches": counts, **held, "its_mesh": [MP_OOC_ITERS / secs] + its_m,
                           "its_single": [MP_OOC_ITERS / s_secs] + its_s}
    print(f"[{card}] 18f streamed {MP_OOC[0]}x{MP_OOC[1]} K={MP_OOC[2]} on the 1x1 NCCL mesh, "
          f"pallas, {MP_OOC_ITERS} iterations: K1/K2 numerator_only "
          f"{counts['update_h_numerator']}/{counts['update_w_numerator']}, full K1 "
          f"{counts['update_h']}, K3 {counts['kl_cost']}; {held} to the single-device streamed "
          f"solve; it/s mesh {rec['streamed 1x1']['its_mesh']} against single-device "
          f"{rec['streamed 1x1']['its_single']}")
    tr_cfg = cfgs["transform"]
    tr, t_secs, _ = _mp_counts(lambda: nt.transform_out_of_core(
        x, w, config=tr_cfg, block_n=MP_TR_BLOCK, mesh=mesh))
    tr1, t1_secs = _timed(lambda: nt.transform_out_of_core(x, w, config=tr_cfg,
                                                           block_n=MP_TR_BLOCK, device=DEVICE))
    twins["transform"] = tr1
    held = _mp_hold("18f transform 1x1", tr.cost, tr1.cost, [(tr.h, tr1.h)])
    rec["transform 1x1"] = {**held, "seconds_mesh": t_secs, "seconds_single": t1_secs}
    print(f"[{card}] 18f transform_out_of_core on the 1x1 mesh (block {MP_TR_BLOCK}, "
          f"{MP_TR_ITERS} iterations a block): {held} to the single-device transform; "
          f"{t_secs} s against {t1_secs} s")
    on_fn = lambda m_: nt.solve_online(x, w, cfgs["online"], block_n=MP_ONLINE_BLOCK,  # noqa: E731
                                       inner_iters=MP_ONLINE_INNER, mesh=m_, device=DEVICE)
    on, o_secs, counts = _mp_counts(lambda: on_fn(mesh))
    check(counts == _mp_want(), f"18f online 1x1: counts {counts}, expected none")
    on1, o1_secs = _timed(lambda: on_fn(None))
    twins["online"] = on1
    held = _mp_hold("18f online 1x1", on.learning_curve[-1], on1.learning_curve[-1],
                    [(on.w, on1.w)])
    blocks = len(on.blocks)
    rec["online 1x1"] = {**held, "blocks_per_s_mesh": blocks / o_secs,
                         "blocks_per_s_single": blocks / o1_secs}
    print(f"[{card}] 18f online on the 1x1 mesh ({blocks} blocks of {MP_ONLINE_BLOCK}): no "
          f"launch (plain, as JAX); {held} to the single-device learner; "
          f"{blocks / o_secs} blocks/s against {blocks / o1_secs}")
    del x, w, h, res, single
    torch.cuda.empty_cache()
    tx, w, h = _mp_tiled()
    for backend in ("auto", "jnp"):
        cfg = dataclasses.replace(cfgs["tiled"], backend=backend)
        for kw in (dict(device=DEVICE), dict(mesh=mesh)):      # warm both
            nt.solve_sparse_tiled(tx, w, h, dataclasses.replace(cfg, max_iter=2), **kw)
        res, secs, counts = _mp_counts(lambda: nt.solve_sparse_tiled(tx, w, h, cfg, mesh=mesh))
        want = _mp_tiled_want(backend == "auto")
        check(counts == want, f"18f tiled 1x1 {backend}: counts {counts}, expected {want}")
        out["launches"][f"mesh paths 1x1 tiled {backend}"] = counts
        one, one_secs = _timed(lambda: nt.solve_sparse_tiled(tx, w, h, cfg, device=DEVICE))
        twins[f"tiled {backend}"] = one
        held = _mp_hold(f"18f tiled 1x1 {backend}", res.cost, one.cost,
                        [(res.w, one.w), (res.h, one.h)])
        bits = all(torch.equal(_bits(getattr(res, f)), _bits(getattr(one, f))) for f in "wh")
        split = {"mesh": [], "single": []}
        for tag in ("mesh", "single", "single", "mesh"):
            split[tag].append(_mp_tiled_split(tx, w, h, cfg, mesh if tag == "mesh" else None))
        psum_us = _mp_psum_us(mesh, w.shape[1])
        rec[f"tiled 1x1 {backend}"] = {"launches": counts, **held, "bitwise_single": bits,
                                       "its_mesh": MP_TILED_ITERS / secs,
                                       "its_single": MP_TILED_ITERS / one_secs,
                                       "prepare_loop_s_mesh": split["mesh"],
                                       "prepare_loop_s_single": split["single"],
                                       "psum_host_us": psum_us}
        print(f"[{card}] 18f tiled {tx.shape[0]}^2 K={w.shape[1]}, {tx.tiles.shape[0]} tiles on "
              f"the 1x1 mesh, {backend}: K5 {counts['K5 h_numerator']}/"
              f"{counts['K5 w_numerator']}; {held} to the single-device tiled solve (bitwise "
              f"{bits}); {MP_TILED_ITERS / secs} it/s against {MP_TILED_ITERS / one_secs}; "
              f"(prepare s, loop s) in turns mesh {split['mesh']} single {split['single']}; "
              f"a K-sized psum over one axis of the 1x1 mesh {psum_us} us of host time")
    del tx, w, h
    xs, ws, hs = _mp_batch(0)
    b = xs.shape[0]
    nt.solve_batched(xs[:2], ws[:2], hs[:2], dataclasses.replace(cfgs["batched"], max_iter=2),
                     device=DEVICE)
    res, secs, counts = _mp_counts(lambda: nt.solve_batched(xs, ws, hs, cfgs["batched"],
                                                            mesh=mesh))
    want = _mp_batched_want()
    check(counts == want, f"18f batched 1x1: counts {counts}, expected {want}")
    out["launches"]["mesh paths 1x1 batched"] = counts
    one, one_secs = _timed(lambda: nt.solve_batched(xs, ws, hs, cfgs["batched"], device=DEVICE))
    twins["batched"] = one
    bits = torch.equal(_bits(res.w), _bits(one.w)) and torch.equal(_bits(res.h), _bits(one.h))
    fro = max(_mp_fro(res.w[i], one.w[i]) for i in BATCH_CHECK)
    check(fro <= MP_FRO, f"18f batched 1x1: member rel Frobenius {fro} to the single device")
    rec["batched 1x1"] = {"launches": counts, "bitwise_single": bits, "fro": fro,
                          "problem_its_mesh": b * BATCH_ITERS / secs,
                          "problem_its_single": b * BATCH_ITERS / one_secs}
    print(f"[{card}] 18f config 4 batch ({b} x {BATCH_SHAPE[1]}x{BATCH_SHAPE[2]} K="
          f"{BATCH_SHAPE[3]}) on the 1x1 mesh, pallas: K1/K2/K3 {counts['update_h']}/"
          f"{counts['update_w']}/{counts['kl_cost']}; bitwise to the single-device batch {bits}; "
          f"{b * BATCH_ITERS / secs} problem-it/s against {b * BATCH_ITERS / one_secs}")
    del xs, ws, hs, res
    xsel = _sel_problem(0)
    one = nt.solve_restarts(xsel, rank=SEL_SHAPE[2], n_restarts=SEL_RESTARTS,
                            config=cfgs["restarts"], seed=0, device=DEVICE)
    twins["restarts"] = one
    x, w, h, _ = _mesh_reference()
    cfg = cfgs["reference"]
    single = nt.solve(x, w, h, cfg, device=DEVICE)
    twins["reference"] = single
    for sharded in (False, True):
        tag = "sharded" if sharded else "gathered"
        (state, bits), secs, counts = _mp_counts(lambda: _mp_ckpt(
            mesh, x, w, h, cfg, os.path.join(tmp, f"ckpt_{tag}"), sharded))
        check(bits, f"18f checkpoints 1x1 {tag}: the resumed run differs from the uninterrupted")
        held = _mp_hold(f"18f checkpoints 1x1 {tag}", state.cost_history[-1], single.cost,
                        [(state.w, single.w), (state.h, single.h)])
        rec[f"ckpt 1x1 {tag}"] = {**held, "bitwise_resume": bits, "seconds": secs,
                                  "launches": counts}
        print(f"[{card}] 18f checkpointed reference solve on the 1x1 mesh ({tag}, every "
              f"{MP_CKPT_EVERY}; uninterrupted, then half and resumed): resume bit-equal; "
              f"{held} to the single-device solve; {secs} s for the three runs; launches "
              f"{counts['update_h_numerator']}/{counts['update_w_numerator']} numerator_only")
    from nmf_tpu_torch.parallel.mesh import shutdown

    shutdown()       # make_mesh's one-rank NCCL group
    return twins


def _mp_4(card, out, twins):
    """(g) four gloo ranks on the card, one launch: 1x4 streamed, transform
    and online; 2x2 tiled, batched, restarts and checkpoints."""
    with tempfile.TemporaryDirectory(prefix="nmf_mesh_paths_") as d:
        wall, recs = _mp_spawn(d, "--mesh-paths-rank", MP_RANK_SECONDS)
        got = dict(np.load(os.path.join(d, "paths.npz")))
    rec = out["mesh"]["paths"]
    for r, rr in enumerate(recs):
        checks = (("stream", _mp_stream_want()), ("online", _mp_want()),
                  ("tiled auto", _mp_tiled_want(True)), ("tiled jnp", _mp_tiled_want(False)),
                  ("batched", _mp_batched_want()),
                  ("restarts", _mp_restarts_want()))
        for tag, want in checks:
            check(rr[tag]["counts"] == want,
                  f"18g rank {r} {tag}: counts {rr[tag]['counts']}, expected {want}")
        check(rr["batched"]["members"] == BATCH_SHAPE[0] // 4,
              f"18g rank {r}: {rr['batched']['members']} batched members")
        for tag in ("ckpt gathered", "ckpt sharded"):
            check(rr[tag]["bitwise"], f"18g rank {r} {tag}: the resume differs in bits")
    for tag in ("stream", "transform", "tiled auto", "tiled jnp", "ckpt gathered",
                "ckpt sharded"):
        costs = {rr[tag]["cost"] for rr in recs}
        check(len(costs) == 1, f"18g {tag}: costs differ across ranks: {costs}")
    r0 = recs[0]
    st = twins["stream"]
    held = {"streamed 1x4": _mp_hold("18g streamed 1x4", r0["stream"]["cost"], st.cost,
                                     [(got["stream_w"], st.w), (got["stream_h"], st.h)]),
            "transform 1x4": _mp_hold("18g transform 1x4", r0["transform"]["cost"],
                                      twins["transform"].cost,
                                      [(got["transform_h"], twins["transform"].h)]),
            "online 1x4": _mp_hold("18g online 1x4", got["online_curve"][-1],
                                   twins["online"].learning_curve[-1],
                                   [(got["online_w"], twins["online"].w)]),
            # the K5 grid against the same grid on the plain sweeps
            "tiled 2x2": _mp_hold("18g tiled 2x2 auto vs jnp", r0["tiled auto"]["cost"],
                                  r0["tiled jnp"]["cost"],
                                  [(got["tiled_auto_w"], got["tiled_jnp_w"]),
                                   (got["tiled_auto_h"], got["tiled_jnp_h"])], MP_TILED_RTOL),
            "ckpt 2x2": _mp_hold("18g checkpoints 2x2", r0["ckpt gathered"]["cost"],
                                 twins["reference"].cost,
                                 [(got["ckpt_w"], twins["reference"].w),
                                  (got["ckpt_h"], twins["reference"].h)])}
    one = twins["batched"]
    bfro = max(_mp_fro(got["batched_w"][i], one.w[i]) for i in BATCH_CHECK)
    check(bfro <= MP_FRO, f"18g batched 2x2: member rel Frobenius {bfro} to the single device")
    bbits = (np.asarray(got["batched_w"]).tobytes() == one.w.cpu().numpy().tobytes()
             and np.asarray(got["batched_h"]).tobytes() == one.h.cpu().numpy().tobytes())
    sel = twins["restarts"]
    srel = float(np.max(np.abs(np.asarray(r0["restarts"]["costs"]) - sel.costs)
                        / np.abs(sel.costs)))
    check(srel <= MP_COST_RTOL and r0["restarts"]["best"] == sel.best_index,
          f"18g restarts 2x2: costs rel {srel}, best {r0['restarts']['best']} against "
          f"{sel.best_index}")
    its = {"streamed 1x4": MP_OOC_ITERS / max(rr["stream"]["seconds"] for rr in recs),
           "tiled 2x2 auto": MP_TILED_ITERS / max(rr["tiled auto"]["seconds"] for rr in recs),
           "tiled 2x2 jnp": MP_TILED_ITERS / max(rr["tiled jnp"]["seconds"] for rr in recs),
           "batched 2x2 problem": BATCH_SHAPE[0] * BATCH_ITERS / max(
               rr["batched"]["seconds"] for rr in recs)}
    for tag, key in (("stream", "mesh paths 1x4 streamed"), ("tiled auto", "mesh paths 2x2 tiled"),
                     ("batched", "mesh paths 2x2 batched"),
                     ("restarts", "mesh paths 2x2 restarts")):
        out["launches"][key] = r0[tag]["counts"]
    rec["four ranks"] = {**held, "batched_fro": bfro, "batched_bitwise_single": bbits,
                         "restarts_cost_rel": srel, "its": its, "wall_s": wall,
                         "rank_launches": {tag: [rr[tag]["counts"] for rr in recs]
                                           for tag in ("stream", "tiled auto", "batched",
                                                       "restarts")}}
    print(f"[{card}] 18g four gloo ranks on cuda:0, one launch ({wall} s): streamed 1x4 every "
          f"rank K1/K2 numerator_only {MP_OOC_ITERS}/{MP_OOC_ITERS}; online no launch; tiled "
          f"2x2 auto every rank K5 {MP_TILED_ITERS}/{MP_TILED_ITERS}, jnp none; config 4 on 2x2 "
          f"{BATCH_SHAPE[0] // 4} members a rank, K1/K2 {BATCH_ITERS}/{BATCH_ITERS} a rank "
          f"(bitwise to the single-device batch {bbits}, member rel Frobenius {bfro}); R = "
          f"{SEL_RESTARTS} restarts over 'mr' ({SEL_RESTARTS // 2} a rank) K1/K2/K3 "
          f"{SEL_ITERS}/{SEL_ITERS}/{SEL_ITERS // 25} a rank, costs rel {srel}; checkpoints "
          f"2x2 gathered and sharded: every resume bit-equal; held {json.dumps(held)}; it/s "
          f"{json.dumps(its)}")


def _mp_cli_commands():
    """(name, torchrun arguments, files it writes) of 18h's six runs."""
    run = ["run", "X.bin", "W.bin", "H.bin"]
    return {
        "run_ooc": run + ["-o", "Wo.bin", "Ho.bin", "--mesh", "1x1", "--out-of-core",
                          "--block-n", "128"],
        "run_ckpt": run + ["-o", "Wc.bin", "Hc.bin", "--mesh", "1x1", "--checkpoint-dir", "ck",
                           "--checkpoint-every", "50"],
        "run_online": ["run", "X.bin", "W.bin", "-o", "Wl.bin", "Hl.bin", "--mesh", "1x1",
                       "--online", "--block-n", "128"],
        "run_restarts": ["run", "X.bin", "--rank", "16", "--restarts", "4", "-o", "Wr.bin",
                         "Hr.bin", "--mesh", "1x1"],
        "select": ["select", "X.bin", "--ranks", "8,16", "--restarts", "2", "--mesh", "1x1",
                   "--jsonl", "sel.jsonl"],
        "batch": ["batch", "d", "--rank", "8", "--max-iter", "20", "--out-dir", "bout",
                  "--mesh", "1x1"],
    }


def _mp_cli_start(tmp):
    """(h) the CLI's mesh runs under ``torch.distributed.run`` (one rank
    each, all six at once), started: {"procs", "t0"}."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import binio

    nt.fixtures.write_reference_fixtures(tmp)
    os.makedirs(os.path.join(tmp, "d"), exist_ok=True)
    x = binio.read_matrix(os.path.join(tmp, "X.bin"))
    for i in range(2):
        binio.write_matrix(x[:, i * 100:(i + 1) * 100], os.path.join(tmp, "d", f"m{i}.bin"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
         "-m", "nmf_tpu_torch", *args, "-q"],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in _mp_cli_commands().items()}
    return {"procs": procs, "t0": t0}


def _mp_cli_finish(card, out, tmp, started):
    """(h) the six runs of :func:`_mp_cli_start` waited for, each against
    the same call in process on a 1x1 mesh."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.io import binio
    from nmf_tpu_torch.parallel.mesh import FlatMesh, shutdown

    procs = started["procs"]
    errs = {name: p.communicate(timeout=300)[1] for name, p in procs.items()}
    wall = time.perf_counter() - started["t0"]
    for name, p in procs.items():
        check(p.returncode == 0, f"18h {name}: exit {p.returncode}: {errs[name][-2000:]}")
    # the same calls in process, on a 1x1 mesh, each with the config its
    # command line gives
    from nmf_tpu_torch import cli as ncli

    cmds = _mp_cli_commands()
    x = binio.read_matrix(os.path.join(tmp, "X.bin"))
    mesh = nt.make_mesh((1, 1), device=DEVICE)
    w, h = (binio.read_matrix(os.path.join(tmp, f)) for f in ("W.bin", "H.bin"))
    cfg = ncli._config(ncli.build_parser().parse_args(cmds["run_ooc"]))
    read = lambda f: binio.read_matrix(os.path.join(tmp, f))  # noqa: E731
    from nmf_tpu_torch.utils.checkpoint import solve_with_checkpoints

    ooc = nt.solve_out_of_core(os.path.join(tmp, "X.bin"), w, h, cfg, block_n=128, mesh=mesh)
    ck = solve_with_checkpoints(x, w, h, cfg, os.path.join(tmp, "ck_in"), every=50, mesh=mesh)
    on = nt.solve_online(os.path.join(tmp, "X.bin"), w, cfg, block_n=128, mesh=mesh)
    sel = nt.solve_restarts(x, rank=16, n_restarts=4, config=cfg, seed=0,
                            mesh=FlatMesh(mesh, "b"))
    sw = nt.solve_rank_sweep(x, [8, 8, 16, 16], ncli._config(ncli.build_parser().parse_args(
        cmds["select"])), seed=0, mesh=FlatMesh(mesh, "members"))
    xs = np.stack([read(os.path.join("d", f"m{i}.bin")) for i in range(2)])
    rng = np.random.RandomState(0)
    ws = rng.rand(2, xs.shape[1], 8).astype(np.float32)
    hs = rng.rand(2, 8, xs.shape[2]).astype(np.float32)
    bt = nt.solve_batched(xs, ws, hs, ncli._config(ncli.build_parser().parse_args(cmds["batch"])),
                          mesh=FlatMesh(mesh, "batch"))
    shutdown()
    pairs = {"run_ooc": [(read("Wo.bin"), ooc.w), (read("Ho.bin"), ooc.h)],
             "run_ckpt": [(read("Wc.bin"), ck.w), (read("Hc.bin"), ck.h)],
             "run_online": [(read("Wl.bin"), on.w)],
             "run_restarts": [(read("Wr.bin"), sel.best[0]), (read("Hr.bin"), sel.best[1])],
             "batch": [(read("bout/m0.W.bin"), bt.w[0]), (read("bout/m1.H.bin"), bt.h[1])]}
    rec = {}
    for name, ps in pairs.items():
        fro = [_mp_fro(a, b) for a, b in ps]
        same = all(np.asarray(a).tobytes() == np.asarray(b.cpu() if torch.is_tensor(b) else b,
                                                         np.float32).tobytes() for a, b in ps)
        check(max(fro) <= MP_CLI_FRO, f"18h {name}: rel Frobenius {fro} to the in-process run")
        rec[name] = {"fro": fro, "bytes_equal": same}
    got = json.loads(pathlib.Path(tmp, "sel.jsonl").read_text().splitlines()[-1])
    costs = sw.costs
    want = {str(k): float(np.min(costs[np.asarray(sw.ranks) == k])) for k in (8, 16)}
    srel = max(abs(got["best_cost_per_rank"][k] - v) / abs(v) for k, v in want.items())
    check(srel <= MP_COST_RTOL,
          f"18h select: best costs {got['best_cost_per_rank']} against {want}")
    rec["select"] = {"cost_rel": srel}
    out["mesh"]["paths"]["cli"] = {"runs": rec, "wall_s": wall}
    print(f"[{card}] 18h torch.distributed.run --nproc-per-node 1, six at once, beside (g) "
          f"({wall} s from their start): "
          f"run --mesh 1x1 with --out-of-core, --checkpoint-dir, --online, --restarts, select "
          f"--mesh 1x1, batch --mesh 1x1: every exit 0, each output against the same call in "
          f"process: {json.dumps(rec)}")


_MP_RUNS = ("mesh paths 1x1 streamed", "mesh paths 1x4 streamed", "mesh paths 1x1 tiled auto",
            "mesh paths 2x2 tiled", "mesh paths 1x1 batched", "mesh paths 2x2 batched",
            "mesh paths 2x2 restarts")


def _mesh_paths_launches(launches, name):
    """A kernel's launches on 18f-18g's runs (on the four-rank grids, each
    rank's): K1/K2 their ``numerator_only`` launches on the streamed runs
    and their full ones on the batched and restart runs, K3 its own, K5
    its own on the tiled runs."""
    def key(run):
        if name in ("h_numerator", "w_numerator"):
            return f"K5 {name}"
        if "streamed" in run and name in ("update_h", "update_w"):
            return f"{name}_numerator"
        return name

    return {run: launches.get(run, {}).get(key(run), 0) for run in _MP_RUNS}


def phase_mesh(card, tmp, out):
    """18: the mesh and the sharded solves (ROADMAP.md Queue 1 step 12a), then
    the streamed, tiled, batched, online and checkpointed solves on a mesh
    and the CLI's mesh runs (step 12b: (f)-(h))."""
    import nmf_tpu_torch as nt

    print(f"[{card}] phase 18: the mesh: 1x1 NCCL in-process (reference, flagship), 2x2 on "
          "four gloo ranks, the CLI under torch.distributed.run, K1/K2 numerator_only at the "
          "mesh's shapes; then every other path on a mesh: 1x1 in process, 1x4 and 2x2 on "
          "four gloo ranks, the CLI's mesh runs")
    out["mesh"] = {}
    x, w, h, cfg = _mesh_reference()
    for c in (cfg, dataclasses.replace(cfg, max_iter=2)):    # warm the single-device path
        nt.solve(x, w, h, c, device="cuda")
    ref, ref_secs = _timed(lambda: nt.solve(x, w, h, cfg, device="cuda"))
    mesh = nt.make_mesh((1, 1), device="cuda")
    _mesh_1x1(card, out, mesh, ref, ref_secs)
    _mesh_flagship(card, out, mesh)
    cfg8 = dataclasses.replace(cfg, backend="jnp", precision=nt.Precision(x_dtype="int8"))
    _mesh_2x2(card, out, ref, nt.solve(x, w, h, cfg8, device="cuda"))
    mesh_w = nt.gather_result(nt.solve_sharded(x, w, h, cfg, mesh=mesh), mesh).w
    from nmf_tpu_torch.parallel.mesh import shutdown

    shutdown()   # make_mesh's one-rank NCCL group
    _mesh_cli(card, out, tmp, mesh_w)
    _mesh_numerators(card, out)
    # step 12b's paths: the streamed, transform, online, tiled, batched,
    # restart and checkpointed solves on a mesh, and the CLI's
    with tempfile.TemporaryDirectory(prefix="nmf_mesh_paths_") as d:
        twins = _mp_1x1(card, out, d)
    with tempfile.TemporaryDirectory(prefix="nmf_mesh_paths_cli_") as d:
        started = _mp_cli_start(d)      # (h)'s subprocesses run while (g) does
        try:
            _mp_4(card, out, twins)
            _mp_cli_finish(card, out, d, started)
        finally:        # a failed check leaves no subprocess behind
            for p in started["procs"].values():
                if p.poll() is None:
                    p.kill()
                p.communicate()


def _mesh_launches(launches, name):
    """A kernel's launches on phase 18's runs (K5: none run there)."""
    runs = ("mesh 1x1 reference", "mesh 2x2 reference", "mesh 1x1 flagship float32",
            "mesh 1x1 flagship bfloat16")
    key = {"update_h": "update_h_numerator", "update_w": "update_w_numerator"}.get(name, name)
    return {run: launches.get(run, {}).get(key, 0) for run in runs}


# ---------------------------------------------------------------------------
# Phase 19: serving (Queue 1 step 13): artifacts, the served H-only block on
# K1 and K3, stream_bin, the CLI's export and serve, mesh artifacts

SERVE_SHAPE = (2048, 16384, 128, 2048)   # M, N, K, n_block: bench.py:923-924's serving rows
SERVE_ITERS = 50                         # a check every 50 (bench.py:312-315)
SERVE_REPS = 3                           # timed calls after a warm one
SERVE_ISMIR = (1025, 4000, 32, 1024)     # 19b: M, N, K, n_block
SERVE_ISMIR_ITERS = 50
SERVE_MESH_BLOCK = 128                   # 19d: the reference shape in three blocks, one padded
SERVE_MESH_ITERS = 50
SERVE_RANK_SECONDS = 240                 # 19d's four ranks' wall-clock limit
SERVE_COST_RTOL, SERVE_H_FRO = 1e-5, 1e-4
_SERVE_RUNS = ("serve auto float32", "serve jnp float32", "serve auto int8 quantized",
               "serve auto int8 in-program", "serve masked", "serve masked quantized",
               "serve masked int8 in-program", "serve mesh 1x1", "serve mesh 2x2")


def _served(t, x, **kw):
    """(result, host seconds, every count) of one served call, the counts set
    to 0 just before (the call returns H on the host: it ends synced)."""
    _reset_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = t(x, **kw)
    return res, time.perf_counter() - t0, _all_counts()


def _serve_want(backend, blocks, iters, checks):
    """The counts of a served call: K1 each iteration and K3 each check of
    each block where the backend resolved to the kernels, nothing else."""
    want = {key: 0 for key in _all_counts()}
    if backend == "pallas":
        want.update(update_h=blocks * iters, kl_cost=blocks * checks)
    return want


def _block_h0(k, width, idx):
    """A served block's default start: ``RandomState(idx)``, clamped to eps."""
    return np.maximum(np.random.RandomState(idx).rand(k, width).astype(np.float32),
                      np.float32(EPS))


def _hold_served(where, res, ref):
    """A served result against another: the summed cost within
    ``SERVE_COST_RTOL`` and H within ``SERVE_H_FRO`` (relative Frobenius)."""
    rel = abs(res.cost - ref.cost) / abs(ref.cost)
    fro = _rel_fro(torch.from_numpy(res.h), torch.from_numpy(ref.h))
    check(rel <= SERVE_COST_RTOL and fro <= SERVE_H_FRO
          and np.array_equal(res.block_iterations, ref.block_iterations),
          f"{where}: cost rel {rel}, H relative Frobenius {fro}, iterations "
          f"{res.block_iterations} / {ref.block_iterations}")
    return {"cost_rel": rel, "h_fro": fro}


def _serve_host_timed(fn):
    """(fn(), {part: host seconds} of one served call): a block's start H
    (``_h0_block``), its wire arrays (``_place_block``: the padding's
    output, host quantization), the copy into pinned memory and the copy's
    start (``_Uploads.put``), the program's enqueue (``_dispatch``), the
    wait for H on the host (``_fetched``), and the call's wall."""
    from nmf_tpu_torch import serving

    parts = {"_h0_block": serving.ServingTransform, "_place_block": serving.ServingTransform,
             "put": serving._Uploads, "_dispatch": serving.ServingTransform,
             "_fetched": serving.ServingTransform}
    times = dict.fromkeys(parts, 0.0)
    originals = {name: cls.__dict__[name] for name, cls in parts.items()}

    def timed(name, f):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return f(*args, **kw)
            finally:
                times[name] += time.perf_counter() - t0
        return call

    for name, cls in parts.items():
        f = originals[name]
        setattr(cls, name, staticmethod(timed(name, f.__func__)) if isinstance(f, staticmethod)
                else timed(name, f))
    try:
        res, wall = _timed(fn)
    finally:
        for name, cls in parts.items():
            setattr(cls, name, originals[name])
    return res, {**times, "wall": wall}


def _serve_bench(card, out, tmp, seed):
    """(a) bench.py's serving shape: auto and jnp on the f32 wire, int8 on
    the quantized wire and in the program."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.ops.quant import quantize_columns_np
    from nmf_tpu_torch.utils import autotune

    m, n, k, nb = SERVE_SHAPE
    blocks = n // nb
    rng = np.random.RandomState(seed)
    eps = np.float32(EPS)
    x = np.maximum(rng.rand(m, n).astype(np.float32), eps)
    w = np.maximum(rng.rand(m, k).astype(np.float32), eps)
    base = nt.SolveConfig(max_iter=SERVE_ITERS, check_every=SERVE_ITERS)
    int8 = dataclasses.replace(base, precision=nt.Precision(x_dtype="int8"))
    arts = {"auto float32": (base, False),
            "jnp float32": (dataclasses.replace(base, backend="jnp"), False),
            "auto int8 quantized": (int8, True), "auto int8 in-program": (int8, False)}
    autotune.reset_counts()
    ts = {}
    for tag, (cfg, quant) in arts.items():
        path = os.path.join(tmp, f"serve_{tag.replace(' ', '_')}.nmfz")
        nt.save_transform(path, w, nb, cfg, quantized_input=quant)
        ts[tag] = nt.load_transform(path)
    serve_choices = sum(v for (entry, _), v in autotune.CHOICES.items() if entry == "serve")
    check(ts["auto float32"].backend == "pallas" and serve_choices == 3,
          f"19a: the auto f32 artifact resolved to {ts['auto float32'].backend}, "
          f"{serve_choices} serve choices for three auto artifacts (one a load)")
    res, secs = {}, {}
    for tag, t in ts.items():
        t(x[:, :nb])
        t(x)                  # warm: the first calls and the whole pipeline
        r, s, counts = _served(t, x)
        want = _serve_want(t.backend, blocks, SERVE_ITERS, 1)
        check(counts == want, f"19a serve {tag} ({t.backend}): counts {counts}, expected {want}")
        out["launches"][f"serve {tag}"] = counts
        res[tag] = r
        secs[tag] = [s] + [_served(t, x)[1] for _ in range(SERVE_REPS - 1)]
        check(r.h.shape == (k, n) and bool(np.all(np.isfinite(r.h)))
              and bool(np.all(np.isfinite(r.block_costs))), f"19a serve {tag}: H or costs")
    # each served block is solve_h_only on the same block at the resolved backend
    for tag in ("auto float32", "auto int8 quantized"):
        t = ts[tag]
        cfg = dataclasses.replace(arts[tag][0], backend=t.backend)
        for b in range(blocks):
            xb = x[:, b * nb:(b + 1) * nb]
            xin = quantize_columns_np(xb, EPS) if t.quantized else xb
            ref = nt.solve_h_only(xin, w, _block_h0(k, nb, b), cfg, device="cuda")
            check(res[tag].h[:, b * nb:(b + 1) * nb].tobytes() == ref.h.cpu().numpy().tobytes()
                  and np.float32(res[tag].block_costs[b]) == np.float32(ref.cost.item()),
                  f"19a serve {tag}: block {b} differs from solve_h_only at {t.backend}")
    held = _hold_served("19a auto against jnp", res["auto float32"], res["jnp float32"])
    q, p = res["auto int8 quantized"], res["auto int8 in-program"]
    check(q.h.tobytes() == p.h.tobytes() and q.block_costs.tobytes() == p.block_costs.tobytes(),
          "19a: the quantized-input artifact differs from the in-program int8 artifact")
    serial = ts["auto float32"](x, prefetch=False)
    check(serial.h.tobytes() == res["auto float32"].h.tobytes()
          and serial.block_costs.tobytes() == res["auto float32"].block_costs.tobytes(),
          "19a: prefetch=False differs from the pipelined call")
    # rates: cols/s (median of SERVE_REPS), the pinned H2D roofline share
    rates = {}
    for tag, s in secs.items():
        quant = ts[tag].quantized
        wire = x.nbytes // (4 if quant else 1) + (4 * n if quant else 0) + 4 * k * n
        h2d = h2d_rate(wire // blocks)
        med = statistics.median(s)
        rates[tag] = {"cols_per_s": n / med, "seconds": s, "wire_bytes": wire,
                      "h2d_gb_s": h2d / 1e9, "roofline_share": (wire / h2d) / med}
    # the host's share of a served call: each block's start, padding and
    # wire arrays (quantization on the quantized wire), its copy into
    # pinned memory, the program's enqueue, and the wait for its H
    host = {tag: _serve_host_timed(lambda: ts[tag](x))[1]
            for tag in ("auto float32", "auto int8 quantized")}
    # the device's busy share over a served call, and K1/K3 at the block
    from torch.profiler import ProfilerActivity, profile

    shares = {}
    for tag in ("auto float32", "jnp float32", "auto int8 quantized"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, s = _timed(lambda: ts[tag](x))
        with tempfile.TemporaryDirectory(prefix="nmf_trace_") as d:
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            dev = _device_shares(trace)
        shares[tag] = {"busy": dev["busy"] / s, "kernels": dev["kernels"] / s,
                       "h2d": dev["h2d"] / s, "wall_ms": 1e3 * s}
    wd = torch.from_numpy(w).cuda()
    hd = torch.from_numpy(_block_h0(k, nb, 0)).cuda()
    xd = torch.from_numpy(np.ascontiguousarray(x[:, :nb])).cuda()
    per_block = {}
    for name in ("update_h", "kl_cost"):
        kern, plain = _pairs()[name]
        ms, plain_ms = timed_pair(lambda: kern(wd, hd, xd), lambda: plain(wd, hd, xd))
        bms, by = _mu_bound(name, wd, hd, xd, nt.Precision())
        per_block[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
    out["serving"]["bench"] = {"rates": rates, "held_auto_jnp": held, "profile": shares,
                               "host": host,
                               "per_block": per_block, "backend": ts["auto float32"].backend,
                               "int8_backend": ts["auto int8 quantized"].backend}
    print(f"[{card}] 19a serving {m}x{n}, K={k}, blocks of {nb}, {SERVE_ITERS} iterations: auto "
          f"resolved to {ts['auto float32'].backend} (int8 {ts['auto int8 quantized'].backend}); "
          f"a served call launches {out['launches']['serve auto float32']} (jnp: none); every "
          f"block bit-equal to solve_h_only at the resolved backend; auto against jnp {held}; "
          "quantized-input bit-equal to in-program int8; prefetch=False bit-equal")
    for tag, r in rates.items():
        sh = shares.get(tag)
        print(f"[{card}] 19a serve {tag}: {r['cols_per_s']} cols/s (median of {SERVE_REPS}: "
              f"{r['seconds']} s), {r['wire_bytes']} wire bytes, pinned H2D "
              f"{r['h2d_gb_s']} GB/s, roofline share {r['roofline_share']}"
              + (f"; profiled busy {sh['busy']}, kernels {sh['kernels']}, H2D {sh['h2d']} of "
                 f"{sh['wall_ms']} ms" if sh else ""))
    for tag, hs in host.items():
        print(f"[{card}] 19a serve {tag}, host seconds a call ({hs['wall']} s): "
              + ", ".join(f"{part} {v}" for part, v in hs.items() if part != "wall"))
    print(f"[{card}] 19a at the served block {m}x{nb}x{k}: K1 {per_block['update_h']} ms, "
          f"K3 {per_block['kl_cost']} ms (CUDA events, beside the plain versions and bounds)")


def _serve_ismir(card, out, tmp, seed):
    """(b) the ISMIR shape: masked artifacts (plain ops), stream_bin."""
    import nmf_tpu_torch as nt

    m, n, k, nb = SERVE_ISMIR
    blocks = -(-n // nb)
    rng = np.random.RandomState(seed + 19)
    x = rng.rand(m, n).astype(np.float32)
    w = (rng.rand(m, k) + 0.05).astype(np.float32)
    mask = (rng.rand(m, n) > 0.2).astype(np.float32)
    x[mask == 0] = np.nan           # unobserved entries are garbage by contract
    cfg = nt.SolveConfig(max_iter=SERVE_ISMIR_ITERS, check_every=25)
    int8 = dataclasses.replace(cfg, precision=nt.Precision(x_dtype="int8"))
    arts = {"masked": (cfg, False), "masked quantized": (int8, True),
            "masked int8 in-program": (int8, False)}
    res, ts, rates = {}, {}, {}
    for tag, (c, quant) in arts.items():
        path = os.path.join(tmp, f"serve_{tag.replace(' ', '_')}.nmfz")
        nt.save_transform(path, w, nb, c, masked=True, quantized_input=quant)
        ts[tag] = t = nt.load_transform(path)
        t(x, mask=mask)         # warm
        r, s, counts = _served(t, x, mask=mask)
        check(counts == _serve_want("jnp", 0, 0, 0),
              f"19b serve {tag}: counts {counts}: masked artifacts run plain ops")
        check(bool(np.all(np.isfinite(r.h))) and r.h.shape == (k, n), f"19b serve {tag}: H")
        out["launches"][f"serve {tag}"] = counts
        res[tag], rates[tag] = r, n / s
    check(ts["masked quantized"].meta["format_version"] == 4, "19b: the v4 artifact's version")
    q, p = res["masked quantized"], res["masked int8 in-program"]
    check(q.h.tobytes() == p.h.tobytes() and q.block_costs.tobytes() == p.block_costs.tobytes(),
          "19b: masked x quantized differs from the masked in-program int8 artifact")
    ref = nt.solve_masked_h_only(x[:, :nb], w, _block_h0(k, nb, 0), mask[:, :nb],
                                 dataclasses.replace(cfg, backend="jnp"), device="cuda")
    check(res["masked"].h[:, :nb].tobytes() == ref.h.cpu().numpy().tobytes(),
          "19b: the masked artifact's block 0 differs from solve_masked_h_only")
    xp, mp = os.path.join(tmp, "serve_X.bin"), os.path.join(tmp, "serve_M.bin")
    nt.write_matrix(x, xp)
    nt.write_matrix(mask, mp)
    for tag in ("masked", "masked quantized"):
        t = ts[tag]
        streamed = t.stream_bin(xp, mask_path=mp)
        hp = os.path.join(tmp, f"serve_H_{tag.replace(' ', '_')}.bin")
        disk = t.stream_bin(xp, out_path=hp, mask_path=mp)
        check(streamed.h.tobytes() == res[tag].h.tobytes() and disk.h is None
              and nt.read_matrix(hp).tobytes() == res[tag].h.tobytes()
              and disk.block_costs.tobytes() == res[tag].block_costs.tobytes(),
              f"19b {tag}: stream_bin differs from the in-memory call")
    out["serving"]["ismir"] = {"cols_per_s": rates, "costs": {t: r.cost for t, r in res.items()}}
    print(f"[{card}] 19b ISMIR {m}x{n}, K={k}, {blocks} blocks of {nb} (the last padded), 20% "
          f"missing as NaN: masked f32 and v4 masked x quantized artifacts, no launch; v4 "
          f"bit-equal to the masked in-program int8 artifact; block 0 bit-equal to "
          f"solve_masked_h_only; stream_bin with and without out_path byte-equal to the call; "
          f"cols/s {rates}")


def _jax_format_zip(path, w, n_block):
    """A zip in the JAX package's artifact layout, written by hand from its
    meta.json (magic 'nmf_tpu-serving'), w.npy and an empty program.bin."""
    import io
    import zipfile

    import nmf_tpu_torch as nt

    cfg = dataclasses.asdict(nt.SolveConfig(backend="jnp"))
    meta = {"magic": "nmf_tpu-serving", "format_version": 1, "m": int(w.shape[0]),
            "k": int(w.shape[1]), "n_block": int(n_block), "masked": False,
            "quantized_input": False, "mesh_shape": None, "platforms": ["tpu", "cpu"],
            "config": cfg, "jax_version": "0.4.35"}
    buf = io.BytesIO()
    np.save(buf, w)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("meta.json", json.dumps(meta))
        zf.writestr("program.bin", b"")
        zf.writestr("w.npy", buf.getvalue())


def _serve_cli_start(tmp):
    """(c), first half: ``export`` (plain, ``--quantized-input``,
    ``--masked``, ``--mesh 1x1``) in process (it needs no device); then
    three subprocesses started together (``serve``, ``serve`` of a
    JAX-format zip, ``serve --mesh 1x1`` under torch.distributed.run),
    and, in process, ``serve --out-of-core``, ``--no-prefetch``, a
    quantized and a masked serve and ``info``.  Returns what
    :func:`_serve_cli_finish` checks once the subprocesses end."""
    import contextlib
    import io

    import nmf_tpu_torch as nt
    from nmf_tpu_torch import cli

    nb = SERVE_MESH_BLOCK
    nt.fixtures.write_reference_fixtures(tmp)
    x, w = (nt.read_matrix(os.path.join(tmp, f"{s}.bin")) for s in "XW")
    mask = (np.random.RandomState(19).rand(*x.shape) > 0.2).astype(np.float32)

    def at(name):
        return os.path.join(tmp, name)

    nt.write_matrix(mask, at("M.bin"))
    _jax_format_zip(at("jax.nmfz"), w, nb)
    t0 = time.perf_counter()
    common = [at("W.bin"), "--block-cols", str(nb), "-q"]
    for name, flags in (("plain", []), ("quant", ["--x-dtype", "int8", "--quantized-input"]),
                        ("masked", ["--masked"]),
                        ("mesh11", ["--mesh", "1x1", "--backend", "jnp", "--max-iter",
                                    str(SERVE_MESH_ITERS)])):
        rc = cli.main(["export", *common, "-o", at(f"{name}.nmfz"), *flags])
        check(rc == 0, f"19c export {name}: exit {rc}")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    py = [sys.executable, "-m", "nmf_tpu_torch"]
    cmds = {
        "plain": py + ["serve", "plain.nmfz", "X.bin", "-o", "H_plain.bin", "-q"],
        "jax": py + ["serve", "jax.nmfz", "X.bin", "-o", "H_jax.bin"],
        "mesh": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", "1", "-m", "nmf_tpu_torch", "serve", "mesh11.nmfz", "X.bin",
                 "-o", "H_mesh11.bin", "--mesh", "1x1", "-q"],
    }
    procs = {tag: subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for tag, cmd in cmds.items()}
    for name, flags in (("ooc", ["--out-of-core"]), ("serial", ["--no-prefetch"])):
        rc = cli.main(["serve", at("plain.nmfz"), at("X.bin"), "-o", at(f"H_{name}.bin"), "-q",
                       *flags])
        check(rc == 0, f"19c serve {' '.join(flags)}: exit {rc}")
    check(cli.main(["serve", at("quant.nmfz"), at("X.bin"), "-o", at("H_quant.bin"), "-q"]) == 0,
          "19c serve of the quantized artifact")
    check(cli.main(["serve", at("masked.nmfz"), at("X.bin"), "-o", at("H_masked.bin"), "--mask",
                    at("M.bin"), "-q"]) == 0, "19c serve of the masked artifact")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["info", *(at(f"{n}.nmfz") for n in ("plain", "quant", "masked", "jax"))])
    info = text.getvalue().splitlines()
    check(rc == 0 and len(info) == 4 and "serving artifact v1" in info[0]
          and "quantized-input" in info[1] and "masked" in info[2]
          and "JAX package's serving artifact" in info[3], f"19c info: {info}")
    return {"procs": procs, "t0": t0, "x": x, "mask": mask}


def _serve_cli_finish(card, out, tmp, started, mesh11_h):
    """(c), second half: the subprocesses' exits and every file against the
    in-process call (``mesh11_h``: the 1x1 mesh artifact's H in process)."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.utils.convert import serving_from_jax

    def at(name):
        return os.path.join(tmp, name)

    done = {tag: (p.communicate(timeout=300), p.returncode)
            for tag, p in started["procs"].items()}
    wall = time.perf_counter() - started["t0"]
    for tag, ((_, err), rc) in done.items():
        if tag != "jax":
            check(rc == 0, f"19c serve {tag} (subprocess): exit {rc}: {err[-2000:]}")
    (_, err), rc = done["jax"]
    check(rc == 2 and "JAX package's serving artifact" in err and not os.path.exists(
        at("H_jax.bin")), f"19c: a JAX-format zip served: exit {rc}: {err[-500:]}")

    def read(name):
        return nt.read_matrix(at(name)).tobytes()

    x, mask = started["x"], started["mask"]
    plain = nt.load_transform(at("plain.nmfz"))(x)
    for name in ("H_plain.bin", "H_ooc.bin", "H_serial.bin"):
        check(read(name) == plain.h.tobytes(), f"19c {name} differs from the in-process call")
    quant = nt.load_transform(at("quant.nmfz"))(x)
    check(read("H_quant.bin") == quant.h.tobytes(), "19c H_quant.bin differs from in-process")
    masked = nt.load_transform(at("masked.nmfz"))(x, mask=mask)
    check(read("H_masked.bin") == masked.h.tobytes(), "19c H_masked.bin differs from in-process")
    check(read("H_mesh11.bin") == mesh11_h.tobytes(),
          "19d: serve --mesh 1x1 under torch.distributed.run differs from the in-process call")
    serving_from_jax(at("jax.nmfz"), at("converted.nmfz"))
    jnp_t = nt.load_transform(at("converted.nmfz"))
    check(jnp_t.backend == "jnp", f"19c: the converted artifact resolved to {jnp_t.backend}")
    out["serving"]["cli"] = {"wall_s": wall, "plain_cost": plain.cost}
    print(f"[{card}] 19c the CLI ({wall} s, its subprocesses beside 19d): export plain, "
          "--quantized-input, --masked and --mesh 1x1; serve (a subprocess), --out-of-core "
          "and --no-prefetch byte-equal to the in-process call, quantized and masked serves "
          "byte-equal; info describes the three artifacts and names the JAX-format zip, which "
          "serve refuses (exit 2) and serving_from_jax carries across; serve --mesh 1x1 under "
          "torch.distributed.run byte-equal to the in-process 1x1 call")


def _serve_rank_main(rank: int, d: str) -> int:
    """One of 19d's four ranks on ``cuda:0`` over gloo (``chip_smoke.py
    --serve-rank R --mesh-dir D``): ``D/mesh.nmfz`` (2x2) served on the
    reference fixture's X; its counts and block results to
    ``D/rank<R>.json``, rank 0's H to ``D/serve.npz``."""
    import torch.distributed as dist

    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank, world_size=4)
    grid = nt.make_mesh((2, 2), device="cuda")
    t = nt.load_transform(os.path.join(d, "mesh.nmfz"), mesh=grid)
    x = _mesh_reference()[0]
    t(x[:, :SERVE_MESH_BLOCK])      # warm
    res, secs, counts = _served(t, x)
    if rank == 0:
        np.savez(os.path.join(d, "serve.npz"), h=res.h)
    pathlib.Path(d, f"rank{rank}.json").write_text(json.dumps({
        "counts": counts, "seconds": secs, "block_costs": res.block_costs.tolist(),
        "block_iterations": res.block_iterations.tolist(), "shape": list(t.mesh_shape)}))
    shutdown()
    return 0


def _serve_mesh(card, out, tmp, cli_x):
    """(d) mesh artifacts at the reference shape, against the single-device
    jnp artifact: 1x1 NCCL in process, 2x2 on four gloo ranks sharing the
    card; returns the CLI's 1x1 artifact's H served in process on
    ``cli_x``, for (c) to hold its torch.distributed.run file to."""
    import nmf_tpu_torch as nt
    from nmf_tpu_torch.parallel.mesh import shutdown

    x, w, _, _ = _mesh_reference()
    nb = SERVE_MESH_BLOCK
    cfg = nt.SolveConfig(max_iter=SERVE_MESH_ITERS, check_every=25, backend="jnp")
    one = os.path.join(tmp, "serve_single.nmfz")
    nt.save_transform(one, w, nb, cfg)
    single = nt.load_transform(one)
    single(x)
    ref, ref_s, _ = _served(single, x)
    mesh = nt.make_mesh((1, 1), device="cuda")
    p11 = os.path.join(tmp, "serve_mesh11.nmfz")
    nt.save_transform(p11, w, nb, cfg, mesh_shape=(1, 1))
    t11 = nt.load_transform(p11, mesh=mesh)
    t11(x)
    r11, s11, counts = _served(t11, x)
    check(counts == _serve_want("jnp", 0, 0, 0), f"19d 1x1: counts {counts}: no kernel on a mesh")
    out["launches"]["serve mesh 1x1"] = counts
    held = {"1x1": _hold_served("19d 1x1 against the single-device jnp artifact", r11, ref)}
    cli11 = nt.load_transform(os.path.join(tmp, "mesh11.nmfz"), mesh=mesh)(cli_x).h
    shutdown()      # make_mesh's one-rank NCCL group
    with tempfile.TemporaryDirectory(prefix="nmf_serve_mesh_") as d:
        nt.save_transform(os.path.join(d, "mesh.nmfz"), w, nb, cfg, mesh_shape=(2, 2))
        wall, recs = _mp_spawn(d, "--serve-rank", SERVE_RANK_SECONDS)
        h22 = np.load(os.path.join(d, "serve.npz"))["h"]
    for r, rr in enumerate(recs):
        check(rr["counts"] == _serve_want("jnp", 0, 0, 0) and rr["shape"] == [2, 2],
              f"19d 2x2 rank {r}: counts {rr['counts']}")
        check(rr["block_costs"] == recs[0]["block_costs"], f"19d 2x2 rank {r}: block costs")
    out["launches"]["serve mesh 2x2"] = recs[0]["counts"]
    r22 = dataclasses.replace(ref, h=h22, block_costs=np.asarray(recs[0]["block_costs"],
                                                                  np.float32),
                              block_iterations=np.asarray(recs[0]["block_iterations"], np.int32))
    held["2x2"] = _hold_served("19d 2x2 against the single-device jnp artifact", r22, ref)
    n = x.shape[1]
    cols = {"single": n / ref_s, "1x1": n / s11,
            "2x2": n / max(rr["seconds"] for rr in recs)}
    out["serving"]["mesh"] = {"held": held, "cols_per_s": cols, "wall_s": wall}
    print(f"[{card}] 19d mesh artifacts {x.shape[0]}x{n}, K={w.shape[1]}, blocks of {nb} (the "
          f"last padded), {SERVE_MESH_ITERS} iterations, plain ops (no launch): 1x1 NCCL in "
          f"process {held['1x1']}; 2x2 on four gloo ranks ({wall} s) {held['2x2']}; cols/s "
          f"{cols}")
    return cli11


def phase_serving(card, tmp, out, seed):
    """19: serving artifacts (ROADMAP.md Queue 1 step 13)."""
    print(f"[{card}] phase 19: serving: bench.py's serving shape through K1/K3 and jnp, "
          "masked and quantized artifacts, stream_bin, the CLI's export and serve, mesh artifacts")
    out["serving"] = {}
    _serve_bench(card, out, tmp, seed)
    _serve_ismir(card, out, tmp, seed)
    started = _serve_cli_start(tmp)     # its subprocesses run while (d) does
    try:
        mesh11_h = _serve_mesh(card, out, tmp, started["x"])
        _serve_cli_finish(card, out, tmp, started, mesh11_h)
    finally:        # a failed check leaves no subprocess behind
        for p in started["procs"].values():
            if p.poll() is None:
                p.kill()
            p.communicate()


def _serve_launches(launches, name):
    """A kernel's launches on phase 19's served calls (K2 and K5: none)."""
    key = {"h_numerator": "K5 h_numerator", "w_numerator": "K5 w_numerator"}.get(name, name)
    return {run[6:]: launches.get(run, {}).get(key, 0) for run in _SERVE_RUNS}


# Phase 20: the examples (ROADMAP.md Queue 1 step 14), each through its main
EX_NAMES = ("basic_usage", "separation_demo", "serving_pipeline", "advanced_features",
            "distributed")
EX_BLOCK_N = 128            # advanced_features' block_n (its streamed sections)
EX_COST_RTOL = 1e-5         # out-of-core against in-memory; 20c against one device
EX_RANK_SECONDS = 300       # 20c's rank group's wall-clock limit
# tests/test_torch_examples.py's tolerances, which 20b holds the card to
# against the CPU: cost rel (bfloat16, separate), factor rtol (COO), atol
EX_COST, EX_BF16_COST, EX_SEP_COST = 1e-5, 1e-3, 1e-4
EX_FRTOL, EX_COO_FRTOL, EX_FATOL = 1e-4, 1e-3, 1e-6
# the route each section's solves take on the H100: "pallas" (K1-K3, K5),
# "jnp" (the rule's batched cuBLAS: the member axis at K <= 32 under
# float32) or "plain" (no kernel exists for the work, or the config asks
# for the plain ops); "pallas" unless named
EX_ROUTES = {
    "advanced_features": {"strict": "plain", "sparse": "plain", "hals": "plain",
                          "online": "plain", "serving": "plain", "restarts": "jnp",
                          "rank_sweep": "jnp", "stability": "jnp"},
    "serving_pipeline": {"masked": "plain", "masked_stream": "plain"},
    "distributed": {"serving": "plain"},
}
# the library's pass-1 Mode of K1/K2 and of K3 in each precision section
EX_MODES = {"tier float32": ("F32", "F32"), "tier float32_fast": ("SPLIT3", "F32"),
            "tier bfloat16": ("BF16", "BF16"), "int8": ("ANY", "ANY")}


def _ex_module(name):
    import importlib

    return importlib.import_module(f"nmf_tpu_torch.examples.{name}")


class _ExSections:
    """The ``section`` hook of an example's ``main``: every count (K1-K3's
    and K5's, the backend choices of ``autotune.CHOICES`` and, on the card,
    the library's pass-1 launches per Mode) set to 0 just before each
    section and read just after, with its host seconds."""

    def __init__(self, card_modes=True):
        self.card_modes, self.records = card_modes, {}

    @contextlib.contextmanager
    def __call__(self, name):
        from nmf_tpu_torch.ops.kernels import _build
        from nmf_tpu_torch.utils import autotune

        lib = _build.load_library() if self.card_modes else None
        if lib is not None:
            lib.nmf_reset_partial_launches()
            lib.nmf_reset_kl_launches()
        _reset_all()
        autotune.reset_counts()
        if lib is not None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if lib is not None:
            torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0, "counts": _all_counts(),
               "routes": sorted({choice for _, choice in autotune.CHOICES})}
        if lib is not None:
            rec["modes"] = {"update_h": [lib.nmf_partial_launches(1, i) for i in range(len(MODES))],
                            "kl_cost": [lib.nmf_kl_launches(i) for i in range(len(MODES))]}
        self.records[name] = rec


def _ex_figures(out, name):
    """Section ``name``'s figures in an example's returned dict."""
    return out["tiers"][name[5:]] if name.startswith("tier ") else out[name]


def _ex_checks(it, every):
    """The checks of a plain loop of ``it`` iterations: one every ``every``
    and one at the last."""
    return -(-int(it) // every)


def _ex_rejects(steps, costs, f, chunk, where, blocks=1):
    """:func:`_rejects` of an accelerated section, from its figures."""
    return _rejects(steps, costs, argparse.Namespace(**f), chunk, where, blocks)


def _ex_want(example, name, out, rec):
    """Every count section ``name`` must show: where its route is
    "pallas", K1-K3 (K5) once a step (sweep) and K3 once a check, read
    from its figures; nothing else, and nothing at all on another route."""
    want = {key: 0 for key in _all_counts()}
    if EX_ROUTES.get(example, {}).get(name, "pallas") != "pallas":
        return want
    f, counts, where = _ex_figures(out, name), rec["counts"], f"20a {example} {name}"
    if name == "tile_sparse":
        want.update({"K5 h_numerator": f["iterations"], "K5 w_numerator": f["iterations"]})
    elif name == "transform":
        # NMF.transform's H-only solve (its iterations are not returned):
        # K1 once an iteration, K3 once a check
        k1 = counts["update_h"]
        check(0 < k1 <= 200, f"{where}: {k1} K1 launches")
        want.update(update_h=k1, kl_cost=_ex_checks(k1, 25))
    elif name in ("serve", "stream", "quantized"):     # a check at 30 of 30 a block
        its = out["quantized" if name == "quantized" else "serve"]["block_iterations"]
        want.update(update_h=int(np.sum(its)), kl_cost=sum(_ex_checks(i, 30) for i in its))
    elif name == "ooc_transform":
        its = f["iterations"]
        want.update(update_h=int(np.sum(its)), kl_cost=sum(_ex_checks(i, 25) for i in its))
    elif name in ("out_of_core", "ooc_accel"):
        # K1 in full and K2 numerator_only on each block, K3 on each block
        # at each cost pass (a seed pass and one a reject when accelerated)
        blocks = -(-f["h"].shape[1] // EX_BLOCK_N)
        steps, costs = f["iterations"], blocks * f["num_checks"]
        if name == "ooc_accel":
            rej = _ex_rejects(counts["update_h"], counts["kl_cost"], f, 10, where, blocks)
            steps, costs = f["iterations"] + 10 * rej, blocks * (1 + f["num_checks"] + rej)
        want.update(update_h=blocks * steps, update_w_numerator=blocks * steps, kl_cost=costs)
    elif name == "train":       # serving_pipeline's accelerated solve, a check every 20
        rej = _ex_rejects(counts["update_h"], counts["kl_cost"], f, 20, where)
        steps = f["iterations"] + 20 * rej
        want.update(update_h=steps, update_w=steps, kl_cost=1 + f["num_checks"] + rej)
    elif name == "sharded":     # K1/K2 numerator_only; the mesh cost is plain, as JAX's
        want.update(update_h_numerator=f["iterations"], update_w_numerator=f["iterations"])
    elif name == "batched":     # one member a rank
        it = int(np.max(f["iterations"]))
        want.update(update_h=it, update_w=it, kl_cost=int(np.max(f["num_checks"])))
    else:                       # a plain solve loop
        it = f["iterations"]
        want.update(update_h=it, update_w=it, kl_cost=f.get("num_checks", _ex_checks(it, 25)))
    return want


def _ex_finite(where, obj):
    """Every number among an example's figures is finite."""
    if isinstance(obj, dict):
        for key, v in obj.items():
            _ex_finite(f"{where}.{key}", v)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _ex_finite(f"{where}[{i}]", v)
    elif isinstance(obj, (float, np.ndarray)) and np.asarray(obj).dtype.kind == "f":
        check(bool(np.all(np.isfinite(obj))), f"{where}: not finite")


def _ex_check_sections(example, out, records, launches):
    """Each section's route (``autotune.CHOICES``), its counts against
    :func:`_ex_want` and, in the precision sections, the Modes K1/K2 and K3
    ran; its launches into ``launches``."""
    for name, rec in records.items():
        where = f"20a {example} {name}"
        route = EX_ROUTES.get(example, {}).get(name, "pallas")
        # a section that resolved a backend resolved its route (a served
        # call resolves nothing: its artifact resolved at load)
        if rec["routes"] and route != "plain":
            check(rec["routes"] == [route], f"{where}: resolved to {rec['routes']}, not {route}")
        want = _ex_want(example, name, out, rec)
        check(rec["counts"] == want, f"{where}: counts {rec['counts']}, expected {want}")
        if name in EX_MODES:
            k12, k3 = EX_MODES[name]
            ran = (_mode_of_counts(rec["modes"]["update_h"], where),
                   _mode_of_counts(rec["modes"]["kl_cost"], where))
            check(ran == (k12, k3), f"{where}: K1/K2 and K3 ran {ran}, expected {(k12, k3)}")
        launches[f"example {example} {name}"] = rec["counts"]


def phase_examples_full(card, tmp, out):
    """(a) every example at full size on the card; returns the figures of
    ``distributed`` (its 1x1 NCCL run, for (c))."""
    import nmf_tpu_torch as nt

    figures = {}
    for name in EX_NAMES:
        argv = ["--device", "cuda"] + (["--out-dir", tmp] if name == "basic_usage" else [])
        hook = _ExSections()
        fig, wall = _timed(lambda: _ex_module(name).main(argv, section=hook))
        _ex_finite(f"20a {name}", fig)
        _ex_check_sections(name, fig, hook.records, out["launches"])
        figures[name] = fig
        out["examples"]["full"][name] = {
            "wall_s": wall, "sections": {
                sec: {"seconds": rec["seconds"],
                      "launches": {k: v for k, v in rec["counts"].items() if v}}
                for sec, rec in hook.records.items()}}
        print(f"[{card}] 20a {name}: {wall} s; each section's seconds and launches "
              f"{json.dumps(out['examples']['full'][name]['sections'])}")
    bu, sp, af = figures["basic_usage"], figures["serving_pipeline"], figures["advanced_features"]
    for path, want in zip(bu["write"]["paths"], (bu["A"]["w"], bu["A"]["h"])):
        check(np.array_equal(nt.read_matrix(path), want), f"20a basic_usage: {path} round trip")
    check(sp["stream"]["bitwise"], "20a serving_pipeline: stream_bin differs from the call")
    check(af["semi"]["frozen_ok"], "20a advanced_features: the frozen columns moved")
    rel = abs(af["out_of_core"]["cost"] - af["in_memory"]["cost"]) / af["in_memory"]["cost"]
    check(rel <= EX_COST_RTOL, f"20a advanced_features: out-of-core cost rel {rel}")
    print(f"[{card}] 20a: the basic_usage files round-trip, stream_bin bitwise, the frozen "
          f"columns intact, the out-of-core cost {rel} (relative) from the in-memory one")
    return figures["distributed"]


def _ex_hold(where, a, b, held, section=""):
    """The card's figures ``a`` against the CPU's ``b`` at the CPU tests'
    tolerances (``section``: the section, or the tier, they belong to); the
    largest relative deviation of each kind into ``held``."""
    if isinstance(a, list) and a and isinstance(a[0], dict):       # separate's components
        check([(c["peak_hz"], c["kind"]) for c in a] == [(c["peak_hz"], c["kind"]) for c in b],
              f"{where}: components {a} / {b}")
        return
    if not isinstance(a, dict):
        check(np.array_equal(np.asarray(a), np.asarray(b)), f"{where}: {a} / {b}")
        return
    check(set(a) == set(b), f"{where}: figures {sorted(a)} / {sorted(b)}")
    for key in a:
        sub = key if section in ("", "tiers") else section
        x, y = a[key], b[key]
        if key in ("paths", "bytes", "spread"):
            continue    # where it wrote, the artifact's size, a derived share
        if key in ("w", "h"):
            if section in ("bfloat16", "hals", "separate"):
                continue    # as the CPU test: the cost alone
            rtol = EX_COO_FRTOL if section == "sparse" else EX_FRTOL
            x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
            check(x.shape == y.shape and np.allclose(x, y, rtol=rtol, atol=EX_FATOL),
                  f"{where}.{key}: largest difference {np.max(np.abs(x - y))}")
            dev = np.max(np.abs(x - y) / np.maximum(np.abs(y), EX_FATOL / rtol))
            held["factor"] = max(held.get("factor", 0.0), float(dev))
        elif key in ("cost", "costs", "pass_costs"):
            rtol = {"bfloat16": EX_BF16_COST, "separate": EX_SEP_COST}.get(section, EX_COST)
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            rel = float(np.max(np.abs(x - y) / np.abs(y)))
            check(rel <= rtol, f"{where}.{key}: relative {rel} > {rtol}")
            held["cost"] = max(held.get("cost", 0.0), rel)
        elif key == "cophenetic":
            dev = float(np.max(np.abs(np.asarray(x) - np.asarray(y))))
            check(dev <= 1e-6, f"{where}.{key}: {dev} > 1e-6")
            held["cophenetic_abs"] = max(held.get("cophenetic_abs", 0.0), dev)
        else:
            _ex_hold(f"{where}.{key}", x, y, held, sub)


def phase_examples_quick(card, tmp, out):
    """(b) every example quick on the card and on the CPU in this process,
    figure by figure at the CPU tests' tolerances."""
    from nmf_tpu_torch.examples._common import QUICK_ENV

    os.environ[QUICK_ENV] = "1"
    try:
        for name in EX_NAMES:
            figs = {}
            for dev in ("cuda", "cpu"):
                argv = ["--device", dev] + (["--out-dir", os.path.join(tmp, dev)]
                                            if name == "basic_usage" else [])
                os.makedirs(os.path.join(tmp, dev), exist_ok=True)
                figs[dev] = _ex_module(name).main(argv)
            held = {}
            _ex_hold(f"20b {name}", figs["cuda"], figs["cpu"], held)
            out["examples"]["quick"][name] = held
            print(f"[{card}] 20b {name} quick, the card against the CPU: largest relative "
                  f"deviations {held}")
    finally:
        del os.environ[QUICK_ENV]


def _example_rank_main(d: str, gloo: bool) -> int:
    """One process of 20c (``chip_smoke.py --example-rank D``): the
    ``distributed`` example at full size on the card, under
    ``torch.distributed.run`` (``--example-gloo``: four ranks on one card
    over gloo) or alone (a 1x1 NCCL mesh); its figures and each section's
    counts to ``D/rank<R>.json``, its global W to ``D/rank<R>.npz``."""
    from nmf_tpu_torch.examples import distributed

    hook = _ExSections(card_modes=False)
    fig = distributed.main(["--device", "cuda"] + (["--gloo"] if gloo else []), section=hook)
    rank = os.environ.get("RANK", "0")
    np.savez(os.path.join(d, f"rank{rank}.npz"), w=fig["sharded"]["w"])
    scalars = {"mesh": fig["mesh"], "iterations": fig["sharded"]["iterations"],
               "num_checks": fig["sharded"]["num_checks"], "cost": fig["sharded"]["cost"],
               "w_rows": fig["sharded"]["w_rows"],
               "batched_costs": fig["batched"]["costs"].tolist(),
               "batched_iterations": fig["batched"]["iterations"].tolist(),
               "batched_num_checks": fig["batched"]["num_checks"].tolist(),
               "serving_cost": fig["serving"]["cost"],
               "counts": {sec: rec["counts"] for sec, rec in hook.records.items()},
               "routes": {sec: rec["routes"] for sec, rec in hook.records.items()}}
    pathlib.Path(d, f"rank{rank}.json").write_text(json.dumps(scalars))
    return 0


def _ex_one_device(x, w0, h0, xs, ws, hs, w_mesh, cols):
    """The costs of ``distributed``'s three parts on one device (no mesh)."""
    import nmf_tpu_torch as nt

    res = nt.solve(x, w0, h0, nt.SolveConfig(max_iter=100, thresh=1e-4, check_every=25),
                   device="cuda")
    bres = nt.solve_batched(xs, ws, hs, nt.SolveConfig(max_iter=50), device="cuda")
    with tempfile.TemporaryDirectory(prefix="nmf_ex_") as td:
        art = os.path.join(td, "one.nmfz")
        nt.save_transform(art, w_mesh, n_block=cols // 2,
                          config=nt.SolveConfig(max_iter=40, backend="jnp"))
        served = nt.load_transform(art, device="cuda")(x)
    return {"cost": float(res.cost), "batched_costs": bres.cost.cpu().numpy(),
            "serving_cost": float(served.cost)}


def _ex_hold_run(where, run, ref):
    """A ``distributed`` run's costs against one device's (rel 1e-5)."""
    rels = {}
    for key in ("cost", "batched_costs", "serving_cost"):
        x, y = np.asarray(run[key], np.float64), np.asarray(ref[key], np.float64)
        rels[key] = float(np.max(np.abs(x - y) / np.abs(y)))
        check(x.shape == y.shape and rels[key] <= EX_COST_RTOL,
              f"{where}: {key} {x} against one device's {y} (relative {rels[key]})")
    return rels


def phase_examples_distributed(card, out, one):
    """(c) ``distributed``: (a)'s in-process 1x1 NCCL run and a 2x2 gloo
    group of four ranks on the card under ``torch.distributed.run``, each
    against the same work on one device."""
    from nmf_tpu_torch.examples import distributed

    (x, w0, h0), (xs, ws, hs) = distributed.inputs(4096, 2048, 128, 1, False)
    ref1 = _ex_one_device(x, w0, h0, xs, ws, hs, one["sharded"]["w"], 2048)
    run1 = {"cost": one["sharded"]["cost"], "batched_costs": one["batched"]["costs"],
            "serving_cost": one["serving"]["cost"]}
    rel1 = _ex_hold_run("20c 1x1", run1, ref1)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="nmf_ex_ranks_") as d:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "4", str(REPO / "chip_smoke.py"), "--example-rank", d,
               "--example-gloo"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=EX_RANK_SECONDS)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"20c 2x2: torch.distributed.run exit {proc.returncode}:\n"
              f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        recs = [json.loads(pathlib.Path(d, f"rank{r}.json").read_text()) for r in range(4)]
        w22 = np.load(os.path.join(d, "rank0.npz"))["w"]
    for r, rec in enumerate(recs):
        where = f"20c 2x2 rank {r}"
        check(rec["mesh"] == {"shape": [2, 2], "world": 4}, f"{where}: mesh {rec['mesh']}")
        check(rec["w_rows"] == [r // 2 * 2048, r // 2 * 2048 + 2048], f"{where}: W rows {rec}")
        check(f"W: rank {r} holds rows {r // 2 * 2048}:{r // 2 * 2048 + 2048}, cols 0:128"
              in proc.stdout, f"{where}: no placement line")
        f = {"sharded": {"iterations": rec["iterations"]},
             "batched": {"iterations": rec["batched_iterations"],
                         "num_checks": rec["batched_num_checks"]}}
        for sec, counts in rec["counts"].items():
            want = _ex_want("distributed", sec, f, {"counts": counts, "routes": rec["routes"][sec]})
            check(counts == want, f"{where} {sec}: counts {counts}, expected {want}")
        for key in ("cost", "batched_costs", "serving_cost"):
            check(rec[key] == recs[0][key], f"{where}: {key} differs from rank 0's")
    (x, w0, h0), (xs, ws, hs) = distributed.inputs(4096, 2048, 128, 4, False)
    ref4 = _ex_one_device(x, w0, h0, xs, ws, hs, w22, 2048)
    rel4 = _ex_hold_run("20c 2x2", recs[0], ref4)
    out["launches"]["example distributed 2x2 rank 0"] = recs[0]["counts"]
    out["examples"]["distributed"] = {"1x1": rel1, "2x2": rel4, "2x2_wall_s": wall}
    print(f"[{card}] 20c distributed at 4096x2048, K=128: 1x1 NCCL in process {rel1}; 2x2 "
          f"gloo on four ranks under torch.distributed.run ({wall} s, every rank exit 0, "
          f"K1/K2 numerator_only on each) {rel4} (relative, against one device)")


def phase_examples(card, tmp, out):
    """20: the five examples (ROADMAP.md Queue 1 step 14)."""
    print(f"[{card}] phase 20: examples: each at full size with its sections' launches, "
          "quick on the card against the CPU, distributed on 1x1 NCCL and 2x2 gloo")
    out["examples"] = {"full": {}, "quick": {}}
    one = phase_examples_full(card, tmp, out)
    phase_examples_quick(card, tmp, out)
    phase_examples_distributed(card, out, one)


def _examples_launches(launches, name):
    """A kernel's launches on each section of phase 20a (K1's and K2's:
    in full and ``numerator_only``)."""
    keys = {"h_numerator": ("K5 h_numerator",), "w_numerator": ("K5 w_numerator",),
            "kl_cost": ("kl_cost",)}.get(name, (name, f"{name}_numerator"))
    return {run[8:]: sum(counts.get(key, 0) for key in keys)
            for run, counts in launches.items() if run.startswith("example ")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="drive nmf_tpu_torch on one NVIDIA card")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)} (default: all)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data phases 9, 10, 12, 13 and 14 make (default 0)")
    ap.add_argument("--backend-out", default=None,
                    help="phase backend: write its measured samples to this JSON file "
                    "(backend_rule.py pools the files of several sessions)")
    ap.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-paths-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--serve-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--example-rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--example-gloo", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_rank is not None:      # one of phase 18c's spawned ranks
        sys.path.insert(0, str(REPO))
        return _mesh_rank_main(args.mesh_rank, args.mesh_dir)
    if args.mesh_paths_rank is not None:    # one of phase 18g's
        sys.path.insert(0, str(REPO))
        return _mp_paths_rank_main(args.mesh_paths_rank, args.mesh_dir)
    if args.serve_rank is not None:         # one of phase 19d's
        sys.path.insert(0, str(REPO))
        return _serve_rank_main(args.serve_rank, args.mesh_dir)
    if args.example_rank is not None:       # one of phase 20c's
        sys.path.insert(0, str(REPO))
        return _example_rank_main(args.example_rank, args.example_gloo)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card, no result",
              file=sys.stderr)
        return 1
    if not (REPO / "nmf_tpu_torch").is_dir():
        print(f"chip_smoke: no nmf_tpu_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    # true f32 GEMMs on the plain path (ROADMAP.md "H100 numerics rules")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_name_and_limit()
    print(f"[{card}] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    out = {
        "kernels": {name: {"max_abs_err": 0.0, "modes": {}, "flagship": {}, "long_walks": {}}
                    for name, _, _ in KERNELS},
        "launches": {}, "cli": {}, "flagship": {}, "tiled": {}, "oocore": {}, "accel": {},
        "families": {}, "transform": {}, "models": {}, "selection": {}, "utils": {},
        "sparse": {}, "backend": {}, "mesh": {}, "serving": {}, "examples": {},
    }
    t_start = time.perf_counter()
    seconds = {}

    def run(name, fn, *args):
        """Phase ``name`` if it was asked for (card always: every other
        phase needs the build), its wall seconds printed."""
        if name in phases or name == "card":
            t0 = time.perf_counter()
            fn(card, *args)
            seconds[name] = time.perf_counter() - t0
            print(f"[{card}] phase {name}: {seconds[name]} s")

    run("card", phase_card, out)
    run("kernels", phase_kernels, out)
    run("modes", phase_modes, out)
    run("quant", phase_quant, out)
    with tempfile.TemporaryDirectory(prefix="nmf_smoke_") as tmp:
        run("cli", phase_cli, tmp, out)
        check("inprocess" not in phases or "cli" in phases,
              "phase inprocess needs phase cli (its files)")
        run("inprocess", phase_inprocess, tmp, out)
    run("flagship", phase_flagship, out)
    run("tilesparse", phase_tilesparse, out)
    with tempfile.TemporaryDirectory(prefix="nmf_ooc_") as tmp:
        run("oocore", phase_oocore, tmp, out, args.seed)
    run("accel", phase_accel, out, args.seed)
    run("families", phase_families, out)
    with tempfile.TemporaryDirectory(prefix="nmf_tr_") as tmp:
        run("transform", phase_transform, tmp, out, args.seed)
    with tempfile.TemporaryDirectory(prefix="nmf_models_") as tmp:
        run("models", phase_models, tmp, out, args.seed)
    with tempfile.TemporaryDirectory(prefix="nmf_sel_") as tmp:
        run("selection", phase_selection, tmp, out, args.seed)
    with tempfile.TemporaryDirectory(prefix="nmf_utils_") as tmp:
        run("utils", phase_utils, tmp, out, args.seed)
    run("sparse", phase_sparse, out)
    with tempfile.TemporaryDirectory(prefix="nmf_backend_") as tmp:
        run("backend", phase_backend, tmp, out, args.backend_out)
    with tempfile.TemporaryDirectory(prefix="nmf_mesh_cli_") as tmp:
        run("mesh", phase_mesh, tmp, out)
    with tempfile.TemporaryDirectory(prefix="nmf_serve_") as tmp:
        run("serving", phase_serving, tmp, out, args.seed)
    with tempfile.TemporaryDirectory(prefix="nmf_examples_") as tmp:
        run("examples", phase_examples, tmp, out)
    print(f"[{card}] phase seconds: {json.dumps(seconds)}")
    if phases != list(PHASES):
        print(f"[{card}] phases {phases} passed in {time.perf_counter() - t_start} s; "
              "a subset prints no result")
        return 0

    kernels = []
    for name, replaces, source in KERNELS:
        st = out["kernels"][name]
        # each kernel's main path: the f32 reference solve for K1-K3, the
        # f32 tiled solve for K5
        tiled = name.endswith("_numerator")
        main_launches = out["launches"]["tiled float32" if tiled else "float32"]
        # each mode: its kernel-vs-plain numbers, and for K1-K3 the launches
        # of its tier's solve; numerator_only: of the streamed solve of its
        # X dtype (none for the GEMM policies, which no streamed run takes)
        modes = {}
        for mode, ms in st["modes"].items():
            if tiled:
                modes[mode] = ms
            elif "launches_of" in ms:
                run, counter = ms["launches_of"]
                modes[mode] = {**{key: v for key, v in ms.items() if key != "launches_of"},
                               "launches": run and out["launches"][run][counter]}
            else:   # null: a mode no solve of phase 6 runs
                modes[mode] = {**ms, "launches": out["launches"].get(mode, {}).get(name)}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": st["max_abs_err"],
            "ms": st["ms"],
            "plain_ms": st["plain_ms"],
            "bound_ms": st["bound_ms"],
            "bound_by": st["bound_by"],
            "library_ms": None,
            **({"impl": st["impl"]} if "impl" in st else {}),
            **({"instance": st["instance"]} if "instance" in st else {}),
            # K3: its launches on the reference, streamed and flagship solves
            **({"solve_launches": {
                "reference": main_launches[name],
                "streamed": out["launches"]["oocore float32"][name],
                "flagship": out["launches"]["flagship float32"][name]}}
               if name == "kl_cost" else {}),
            # registers, shared memory and blocks an SM of each pass-1 instance
            **({"pass1": {label: v for label, v in out["pass1"].items()
                          if label.startswith(PASS1_OF[name] + "<")}}
               if name in PASS1_OF else {}),
            "modes": modes,
            **({"flagship": st["flagship"]} if st["flagship"] else {}),
            **({"long_walks": st["long_walks"]} if st["long_walks"] else {}),
            "accel_launches": _accel_launches(out["launches"], name),
            # phase 15: the checkpointed, live and streamed-resume runs
            # (K1-K3) and the checkpointed tile-sparse run (K5)
            "utils_launches": _utils_launches(out["launches"], name),
            # phase 18: K1/K2 numerator_only (K3: none) on the mesh solves
            "mesh_launches": _mesh_launches(out["launches"], name),
            # 18f-18g: the streamed, tiled, batched and restart solves on a mesh
            "mesh_paths_launches": _mesh_paths_launches(out["launches"], name),
            # phase 19: each served call (K1 and K3 on the auto artifacts)
            "serve_launches": _serve_launches(out["launches"], name),
            # phase 20a: each section of each example at full size
            "examples_launches": _examples_launches(out["launches"], name),
            # K1-K3: their launches on phase 12's H-only runs (K2: none)
            **({"transform_launches": _transform_launches(out["launches"], name),
                "models_launches": _models_launches(out["launches"], name),
                # phase 14: one launch a batched call, whatever its members
                "selection_launches": _selection_launches(out["launches"], name),
                "batched": st["batched"]}
               if name in ("update_h", "update_w", "kl_cost") else {}),
        })
    print(f"[{card}] oocore summary: {json.dumps(out['oocore'])}")
    print(f"[{card}] accel summary: {json.dumps(out['accel'])}")
    print(f"[{card}] families summary: {json.dumps(out['families'])}")
    print(f"[{card}] transform summary: {json.dumps(out['transform'])}")
    print(f"[{card}] models summary: {json.dumps(out['models'])}")
    print(f"[{card}] selection summary: {json.dumps(out['selection'])}")
    print(f"[{card}] utils summary: {json.dumps(out['utils'])}")
    print(f"[{card}] sparse summary: {json.dumps(out['sparse'])}")
    print(f"[{card}] backend summary: {json.dumps(out['backend']['auto'])}")
    print(f"[{card}] mesh summary: {json.dumps(out['mesh'])}")
    print(f"[{card}] serving summary: {json.dumps(out['serving'])}")
    print(f"[{card}] examples summary: {json.dumps(out['examples'])}")
    print(f"[{card}] all twenty phases passed in {time.perf_counter() - t_start} s "
          f"(kernel build {out['build_seconds']} s)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
