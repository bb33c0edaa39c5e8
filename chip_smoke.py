"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port and the rate probes from
``scann_tpu_torch/csrc`` (one nvcc per source, all at once) into a fresh
kernel build cache, ``build/scann_tpu_torch/chip_smoke_exec_cache``
(``utils/exec_cache.py``), and prints the registers and spills (``ptxas
-v``) of the two backward kernels in f32 and in bf16, of #3 and #5, and of
the wide and tall builds of #5, #3 and #4 (#4's in both operand modes).
Phases 11 and 12 run first:

11. measures the card's rates with the probes of ``csrc/roofline_probe.cu``
   (``utils.roofline.measure_device_rates``: ``expf``, FP32 FMA, TF32 and
   BF16 ``mma.sync``, HBM stream over 1 GiB) and prints each beside its
   published peak (``utils.flops``), the SM clock and the power limit; a
   rate over 105% of its peak fails (a wrong probe). Every later bound is
   also taken at these rates (``measured_bound_ms``, beside the published
   ``bound_ms``, which stays the bound); prints the step ceilings
   (``step_ceiling``) of the QM9 and MP2018 shapes;
12. featurizes the same structures by the native Voronoi path
   (``native/voronoi_cell.cc``, the default) and the scipy/Qhull path:
   MP2018-like crystals of phase 10's set, phase 8's served crystals (20-200
   sites) and QM9-like molecules of phase 5's set; prints ms per structure
   on each path and fails if the neighbour records differ.

Phases 1-5 run at the full width of the
flagship QM9 SCANN+ model (``configs/model_qm9.yaml``: 7 layers, D=128, 8
heads, embedding 48), phases 6-10 at the full width of the crystal models
(``configs/model_mp2018.yaml``: SCANN+, 9 layers, D=128, embedding 128,
vocab 95; ``configs/model_ptgp.yaml``: SCANN with ring features, 11
layers); random weights from seeds:

1. holds the forward kernel against its plain PyTorch version, unpacked
   and on packed slots (structure packing: several structures a slot, up to
   8 segments, at least one empty; the small matrix in slots of 16 rows and
   QM9 molecules of 3-29 atoms at the flagship's packing capacity 48 and at
   the derived 32);
2. serves a few molecules over HTTP through ``PredictionServer`` (the
   serving path) and checks every answer against the eager model; spans
   (``utils.Timer``, each ended by ``torch.cuda.synchronize()``) split each
   request's wall time into queue wait, featurize, hand-off, pad/launch and
   response (``ServingSpans``);
3. times both kernels at the QM9 batch shape against their bounds and
   their plain versions, and the packed forward at capacity 48 and the
   packed backward at capacity 32;
4. holds the products of ``csrc/scann_mma.cuh`` (split-TF32 ``mma.sync``, the
   three forms the backward kernels use) against a float64 product, then the
   backward kernel (at dropout 0 and 0.1, one-shot and with a
   GA cotangent) and the forward kernel with dropout against their plain
   versions on the same Philox masks, unpacked and packed;
5. writes 1000 synthetic QM9-like molecules with
   ``builders.common.save_dataset`` and featurizes them through
   ``cli.preprocess`` (the dataset path: ``parallel_compute_neighbors`` on 8
   spawned processes), prints the pool's wall time beside the serial
   ``featurize_record``'s on 128 of them and holds their records equal; then
   trains 2 epochs on those two files through ``Scann.prepare_dataset ->
   train -> evaluate`` (the training path) in the flagship recipe's two
   buckets; checks the launches, that each pass over
   a bucket lowers that bucket's loss without dropout, that the same run
   with the plain step gives the same losses, 3 kernel steps against 3
   plain steps and ``load_model_infer``; resumes through
   ``Scann(pretrained=<run>/checkpoints/last)`` and holds one step of the
   loaded trainer equal, bit for bit, to the same step of the trainer put
   back in that state (params, Adam moments, step); then trains 2 epochs in one
   bucket and checks that the epoch loss and the training-set loss fall;
   then, with ``tpu.structure_packing`` on the same molecules, 3 epochs at
   packing capacity 48 (eval by the molecule forward, steps by the loop
   backward) and 1 at the derived capacity 32 (steps by the molecule
   backward): the routes, one launch per step and per eval batch, a falling
   loss, ``predict_data`` per structure (values and GA scores) against the
   unpacked pipeline with the same parameters, and occupancy, slots, slot
   batch, median step and structures/s beside the unpacked run's;
6. holds the crystal loop-forward kernel against its plain version at 1, 2
   and 4 blocks per structure: a small matrix of configurations (two atom
   blocks, ragged counts, single atoms, fewer atoms than blocks, dropout 0
   and 0.1 with attention dropout), a ragged M=160 at B=20, the gate's edge
   M=232, MP2018 (B=64 and B=128, M=96, N=32) and Pt/graphene (B=64, M=128,
   N=32) at full width, and packed slots (the small matrix, MP2018-like
   crystals of 20-90 sites at packing capacity 96), each with further
   launches on a kept scratch filled with NaN or a constant that must give
   the same pred and ga bit for bit; and times it in turns with its plain
   version at MP2018 on 2 blocks and on 1 block per structure, at B=128, at
   Pt/graphene and packed at capacity 96;
7. holds the per-layer LocalAttention kernel against its plain version
   (out, geometry, attention; SCANN+ and SCANN) at a ragged small layer, at
   an M beyond the loop kernel's gate (8, 256, 32) and at one MP2018 layer
   (64, 96, 32), each relaunched into outputs filled with NaN that must
   come back bit for bit; times it in turns with its plain version at the
   last two shapes (and back to back, without the host's share of a call);
   holds the per-layer model against the eager model for
   ``use_attn_norm: false``;
8. (run after phase 10) serves synthetic periodic crystals of 20-90 sites, posted as
   CIF and as JSON, and one of 200 sites that takes the per-layer route,
   through ``PredictionServer`` on the MP2018 model that phase 10 trained,
   loaded from its run directory (``BatchedPredictor.from_model_dir``; the
   crystal serving path); prints each request's batch size (a group
   launches at its own size), checks every answer against the eager model
   and the launches of each route against the batches that took it, and
   splits each request's wall time by spans as phase 2 does;
9. holds the crystal loop-backward kernel against its plain version (the
   eager training forward under ``torch.autograd``, same Philox masks): a
   small matrix in cotangent and one-shot mode at dropout 0 and 0.1, atom
   blocks of 32, 16 and 8, structures with fewer atoms than blocks and with
   unequal shares, then MP2018 (B=64, M=96, at N=32 and at N=16) and
   Pt/graphene (B=64, M=128, N=32) at full width, and packed slots (the
   small matrix, QM9 at capacity 48, MP2018-like crystals at 96) at every
   cluster size the kernel launches with (1, 2 and, for small batches, 4
   blocks per structure), each with further launches on a kept scratch
   filled with NaN or a constant that must give the same gradients bit for
   bit, and times it in turns with its plain version (plain, kernel, kernel,
   plain), at one block per structure beside the cluster, at B=128 beside
   B=64, and packed at QM9 capacity 48 and crystal capacity 96;
10. trains 2 epochs through ``Scann.prepare_dataset -> train -> evaluate``
   (the crystal training path) on 480 synthetic periodic crystals of 20-90
   sites at the full width and depth of the MP2018 model, batch 64, in the
   recipe's 4 buckets with the neighbour axis padded to the recipe's 32 (the
   largest is the recipe's (96, 32)); holds the kernel against its plain
   version on the first batch of every bucket; checks one loop-backward
   launch per step and none of the molecule backward, the eval launches
   against the routes, the same run with the plain step and
   ``load_model_infer``; trains 2 epochs in one bucket (96, 16), where every
   pass must lower the loss without dropout; and takes one training step by
   the per-layer route at (248, 64) of the model without the attention
   LayerNorm, which the loop backward refuses (the
   plain model under autograd, as the JAX Trainer trains: no launch of the
   per-layer kernel), held against the plain step and timed beside it; then
   one packed epoch of the same crystals at
   capacity 96 (eval by the loop forward, steps by the loop backward),
   checked as phase 5's packed runs; and two training steps at (96, 32)
   under ``utils.trace`` (``torch.profiler``, as ``cli/train.py --profile``
   runs it): the Chrome trace must be written, and its CUDA kernel events
   are counted and summed by name.
14. model.dtype bfloat16: holds kernels #1 and #3 in the bf16 operand mode
   (``kernels/dots.py``: both operands of every product rounded to
   bfloat16, f32 sums) and #5 on bfloat16 tensors against their bf16 plain
   versions (``reference_bf16_forward``, ``reference_layer_kernel``) at full
   width: #1 at QM9 and packed at capacity 48, #3 at MP2018 (B=64) and
   packed at capacity 96 (relaunched on NaN- and constant-filled scratch,
   bit for bit), #5 at one MP2018 layer and at (8, 256, 32) (relaunched
   into NaN-filled outputs), and #1 and #3 again at the same widths,
   inputs, clusters and packing with one layer; every full-depth output
   within rtol 0.05 / atol 0.02 of the f32 kernel on the same inputs. The
   mean difference must be at most 0.1 x the plain version's bf16-vs-f32
   mean difference, or 2 x the f32-noise floor (the bf16 plain version with
   f32 against f64 sums between its roundings) where that is larger: #3
   with one layer and both at full depth, where the f32 sum order alone
   moves the plain version by 0.18-0.76 x that gap. There the kernel must
   also lie within 0.5 x (one layer) or 0.9 x (full depth) of the f32
   kernel's own distance from the bf16 plain version, the reading of a
   kernel that skipped the mode, printed for every case. Times each
   bf16 kernel in turns with the f32 one. Then the main path: one request
   of a bf16 QM9 model and one of a bf16 MP2018 model (a 90-site crystal by
   #3's narrow build, a 260-site one at the rung M = 384 by its tall build)
   through ``PredictionServer``, then one request of the 90-site crystal to
   an MP2018 model with ``use_attn_norm: false``, which no whole-model
   kernel takes (the per-layer route: #5 on every layer), in bf16 and in
   f32; each answer equal, bit for bit, to ``Scann.predict_structure``; the
   launch counts, set to 0 before, must match the routes: #1 and #3 in bf16
   above 0, #3's tall build once, #5's bf16 entry on the 9 layers of the
   bf16 model and its f32 entry on those of the f32 one.
15. model.dtype bfloat16 training: holds kernels #2 and #4 in the bf16
   operand mode against their bf16 plain versions (``reference_bf16_forward``
   under ``torch.autograd``: every product rounds both operands, the
   cotangent of a transposed product included) on the small matrix at
   dropout 0.1 (unpacked and packed), then #2 at QM9 and packed at capacity
   32 and #4 at MP2018 (B=64, 2 blocks a structure) and packed at QM9
   capacity 48, each at dropout 0 and 0.1 at full depth and at 0.1 with one
   layer at the same widths, inputs, clusters and packing. For each case it prints,
   for the gradients flattened into one vector and for pred, (a) the bf16
   kernel's mean distance from the bf16 plain version, (b) the plain
   version's bf16-vs-f32 gap, (c) the f32-noise floor and (d) the f32
   kernel's distance from the bf16 plain version (the reading of a kernel
   that skipped the mode); (c) is the largest of the plain version against
   itself with f64 arithmetic between the roundings and on weights moved by
   about one f32 ulp in three draws. Both kernels relaunch bit for bit, #4 on NaN- and
   constant-filled scratch at 1, 2 and 4 blocks a structure. Times #2 at QM9
   and #4 at MP2018 in bf16 in turns with f32. Then the main path, each run
   in one bucket: a bf16 QM9 model trains 2 epochs on phase 5's molecules
   (steps by #2; a step resumed from ``checkpoints/last`` equal bit for
   bit), a bf16 MP2018 model 2 epochs on phase 10's crystals at (96, 32)
   (steps by #4) and 2 at (96, 64) (steps by #4's wide build in bf16);
   every epoch loss and training-set loss finite and falling, the bf16
   launches of #2 and #4, set to 0 before each run, equal to the steps of
   their routes, #4's wide launches to the steps of the (96, 64) run.
16. the activation stashes of #2 and #4, the TPU kernels' default training
   schedules, which the main paths above run (phases 5, 10, 13 and 15
   print their launches by schedule; phases 5, 10 and 13 fail without an
   f32-stash launch, and phase 9's relaunches on NaN- and constant-filled
   scratch run in the f32 stash at every cluster size). #4's selective
   stash at MP2018 (64, 96, 32) with 2 blocks a structure, Pt/graphene
   (64, 128, 32), QM9 packed at capacity 48 and MP2018 packed at 96, #2's
   keep-acts stash at QM9 (128, 32, 16) and packed at 32, at dropout 0.1:
   the f32 stash bit for bit against the recompute launch, with f32 and
   with bf16 operands; the bf16 stash against its plain version (its mean
   distance (a) at most 0.1 x the plain bf16 stash's gap (b) to the f32
   plain version or 2 x the f32 kernel's distance (c) from it, and at most
   0.5 x the recompute kernel's distance (d) from the bf16 plain version);
   #4's bf16 stash relaunched on NaN- and constant-filled scratch at 1, 2
   and 4 blocks a structure, bit for bit. Times the f32 stash at every
   shape and the bf16 stash at the unpacked ones in turns with the
   recompute schedule (recompute, stash, stash, recompute; 3 + 8 reps),
   beside the stash's bytes. Then the bf16 stashes on the main path,
   through ``fused_scann_train_grads`` (QM9, ``SCANN_TPU_STASH_BF16=1``)
   and ``loop_scann_train_grads`` (Pt/graphene at B=128, whose 9.0 GB f32
   stash exceeds the budget, ``SCANN_TPU_LOOP_STASH_BF16=1``): one
   bf16-stash launch each, held as above.
17. wide neighbour lists (the wide builds of #5, #3 and #4, N > 64 for the
   forwards and N > 32 for #4, up to 256): #5 at one MP2018 layer at (8,
   96, 96), (8, 64, 128), (4, 32, 256), (8, 96, 72) and the odd N of (2,
   73, 81), SCANN+ and SCANN, and at (8, 96, 96) at every atom block its
   plan can take (forced through the wrapper's plan by the SM count it
   plans for), on f32 tensors (against the plain layer at the forward
   tolerances) and bfloat16 tensors (within one bf16 ulp of the plain
   version), each relaunched into NaN-filled outputs bit for bit; #3 and
   #4 at MP2018 (8, 80, 96), (8, 60, 128) and (4, 96, 72), Pt/graphene (8,
   120, 96) and a packed
   wide slot (capacity 96, N = 96), and #4 alone at MP2018 (4, 64, 48) and
   (4, 96, 40) (a short last sub-chunk of 16 and 8 rows), #3 alone past its
   old edge at (2, 300, 96), with its keys in global memory at (2, 40,
   256) and at the odd N of (2, 73, 81) and (2, 30, 199); #4 at 1, 2 and 4
   blocks a structure, #3 at 1, 2, 4, 8 and 16 and at
   its own choice (``kloop.forward_cluster``), each with NaN- and
   constant-filled relaunches bit for bit; #4 at dropout 0.1 with attention
   dropout in its three schedules (the
   f32 stash against the plain gradients at 1e-4 x max, recompute bit for
   bit equal to it, the bf16 stash held as phase 16 holds it). The inputs'
   neighbour lists are live past one chunk and carry an atom with every
   neighbour masked, one with whole sub-chunks masked and one with only its
   last neighbour live. Times #3 and #4 (f32 stash and
   recompute) at MP2018 (16, 80, 96) and #5 at (8, 96, 96) and at the
   served crystal's (1, 48, 96) in turns with their plain versions (#5 on
   bf16 tensors at (8, 96, 96) in turns with f32, for phase 19's row), #3
   also at B = 1 and 64 (its own cluster sizes).
   Then the main paths, the launch counts set to 0 just before each:
   ``Scann.predict_featurized`` serves a crystal of 40 sites with 80
   neighbours (ladder (48, 96)) and one of 300 (ladder (384, 96)), both on
   #3's wide build, and the first again to an MP2018 model without the
   attention LayerNorm (the per-layer model on #5's wide build), held to
   the eager model; ``Trainer.fit`` trains a synthetic MP2018 model 2 epochs
   in a (64, 48) and a (48, 96) bucket, every step by the "loop" route
   (#4's wide build in both), with finite losses.
18. tall structures (the tall builds of #3 and #4, M past the narrow plans
   at a narrow N): holds (#3 at 1, 2, 4, 8 and 16 blocks a structure and
   its own choice), ``tall=True`` against the narrow builds (#3 bit
   for bit, #4 within its gradient limit: its 64-row chunks sum the weight
   gradients in another order), times (#3 also at B = 1 and 64, #4 at the
   recipe batch of 64),
   a served 300-site crystal and 2 epochs at (304, 32) through
   ``Scann.train`` (``phase18``'s docstrings say what each holds).
19. the bf16 operand mode in the wide and tall builds of #3 and #4
   (``model.dtype: bfloat16`` at every shape the f32 builds take): #3 and
   #4 in bf16 at MP2018 (4, 96, 72) and (4, 80, 96) (wide) and Pt/graphene
   (2, 322, 32) and MP2018 (2, 428, 16) (tall), full width and depth,
   attention dropout on, and with one layer over 16 structures, against
   their bf16 plain versions with phases 14-15's criteria (0.9 x and, with
   one layer, 0.5 x the f32 kernel's reading, #4's training pred 0.9 x
   there too: its f32-noise floor alone is 1.1-1.7 x its bf16 gap; #3 at
   dropout 0 at 1, 2, 4, 8 and 16 blocks a structure and its own choice,
   relaunched on NaN- and constant-filled scratch bit for bit, and at
   dropout 0.1; #4 one-shot at dropout 0.1 at 1, 2 and 4 blocks in its three
   schedules: recompute and the bf16 stash each against its own bf16 plain
   version, the f32 stash bit-equal to recompute, both relaunched bit for
   bit); the tall builds forced at MP2018 (4, 96, 32) and Pt/graphene (4,
   128, 32) in bf16 against the narrow bf16 builds (#3 bit for bit, #4
   within its gradient limit); each bf16
   build timed in turns with its f32 build at the f32 rows' shapes (wide
   MP2018 (16, 80, 96), tall Pt/graphene (16, 322, 32); #3 at its own
   cluster size, #4 at C = 4). Then the main paths, the launch counts set
   to 0 just before each: a bf16 MP2018 model serves a crystal at the rung
   (48, 96) and one at (384, 96), both on #3's wide build in bf16, and a
   bf16 model without the attention LayerNorm serves the second (the
   per-layer model on #5's wide build in bf16); it trains 2 epochs on phase
   18's crystals at (304, 32) (#4's tall build in bf16, one launch a step;
   validation by #3's tall build in bf16), the Trainer's first step held to
   the bf16 plain version; and one training step at (248, 64) of the model
   without the attention LayerNorm (which #4 refuses) keeps the per-layer
   route in bf16 as in f32.
20. widths above 128 (D, G, O up to 256): the ``*_d256`` builds of #1,
   #3, #4 and #5 (``phase20``'s docstrings say what each holds, times and
   drives).
21. the user's scripts (``examples_torch/``) through their own entry
   points on phase 5's molecules: a short training run of the QM9 model on
   the card, then ``interpretability.main`` (two xyz molecules) and
   ``ga_analysis.main`` (the run's 256 molecules) from its run directory on
   the card and again on the CPU, held together at the forward tolerance,
   and ``packed_training.run_once`` bucketed and packed (occupancy, epoch
   seconds and structures/s beside the card); the launch counts, set to 0
   before each script, and the routes the Trainer takes: #1 and #2 (on
   packed slots in the packed run), never #3-#5 or the per-layer route.
22. widths past 256 (D, G, O up to 512): the ``*_d512`` builds of #1, #3,
   #5 and the tall and wide #4 held against their plain versions at (264,
   260, 268), 384 and 512 in f32 and bf16 (relaunched on NaN-filled
   scratch, #1, #3 and #4 at every cluster size; #4 in its three
   schedules), timed in turns with their plain versions, served to D = 384
   and 512 models through ``Scann``, a D = 384 QM9 model and a D = 384
   MP2018 model (f32 and bf16) fitted for one epoch on #4's d512 builds,
   every path checked by its launch counts (``phase22``'s docstrings say
   what each holds, times and drives).
13. (run last) spawns two processes on the one card, each a rank of the
   Trainer's data parallelism on cuda:0 over gloo (passed explicitly: NCCL
   refuses two ranks on one device), both loading every kernel from the
   build cache the first build filled (``stats["compiles"] == 0``, and
   each prints its time from process start to its first finished step):
   4 QM9 steps at the flagship width, batch 128 (64 a rank, #2), on phase
   5's buckets, 2 MP2018 steps at (64, 96, 32) (32 a rank, #4) and one
   sharded eval batch of each (#1, #3). Losses, every weight, predictions
   and GA scores must equal, bit for bit, one process running the same
   shards in rank order (and each other), and the whole-batch run within
   1e-4 (of each tensor's max; losses relative). The ranks' steps go
   through the ``make_sharded_*_train`` wrappers and their loop eval
   through ``make_sharded_loop_forward``; after the counted work each rank
   also calls ``make_sharded_scann_apply`` and ``make_sharded_loop_apply``
   on the eval batches at dropout 0.1 and differentiates them, held bit for
   bit to the shards' forwards and gradients in rank order. A third,
   fresh process then serves one QM9 request through
   ``BatchedPredictor(exec_cache=<that directory>)``: it must load its
   kernel from the disk and build nothing. Prints the phase's wall time.

Phases 5, 8 and 10 featurize through the native Voronoi path and pack
through the native packer (``native/packer.cc``), both built with g++ at
first use; phase 5's featurization pool loads the library phase 12 built.

Prints the card (``nvidia-smi``), the build time, each comparison and
phase, each kernel's share of both bounds, the run's whole time, then one
``{"kernels": [...]}`` line (every row with ``measured_bound_ms`` and
``sharded_launches``, its launches in phase 13's two ranks together; rows
``scann_forward`` to ``local_attention`` and the stash rows with
``scripts_launches``, their launches in phase 21's scripts; the
rows of the four whole-model kernels with ``packed_launches``, their
launches on the packed training runs, and ``packed``, their times at a
packed shape; the tall and wide #3 rows also ``b1_*`` and ``recipe_*``,
their times, bounds and cluster sizes at B = 1 and 64; rows ``1-bf16``,
``3-bf16``, ``5-bf16``, ``2-bf16``,
``4-bf16``, ``3-wide-bf16``, ``3-tall-bf16``, ``4-wide-bf16``,
``4-tall-bf16`` and ``5-wide-bf16`` with their f32 times from the same run,
``f32_ms``, and bounds
that count the products of #1-#4 once at the dense BF16 rate and #5's as in
f32; every row of #2 and #4 names its ``schedule``: rows
``scann_backward`` and ``scann_loop_backward`` are the recompute schedule,
rows ``2-stash``, ``2-stash-bf16``, ``4-stash`` and ``4-stash-bf16`` the
stashes, each with its own schedule's launches on the main, packed and
sharded paths and its own error against its plain version, and with the
recompute schedule's time from the same turns, ``recompute_ms``, the
stash's bytes written and read, ``stash_bytes``, and their time at the
published and the measured HBM rate; the f32 stash rows' ``packed`` is the
f32 stash at the packed shape) and, last,
``{"ok": true, "device": {...}}``. Exits non-zero on any failure, and
without printing a result when CUDA is not available.

``python3 chip_smoke.py --backward-ab ROOT [OUT]`` runs one turn of an A/B
comparison of #2-#5 against another checkout ROOT instead (``backward_ab``;
also the tall and wide #3 at B = 1, 16 and 64, the wide #5 at (1, 48,
96), (8, 96, 96) and (64, 96, 96), in f32 and bf16, and #4's d256 builds
at their timed shapes and (64, 80, 96) recompute; with OUT it
saves the outputs of every build both checkouts have), and
``python3 chip_smoke.py --ab-compare A.pt B.pt`` holds two turns' outputs
bit for bit (``ab_compare``; the tall and wide #4 within their gradient
limit, the tall and wide #3 and the wide #5 at the forward tolerance and,
in bf16, the floor rule), and
``python3 chip_smoke.py --tall-table [OUT]`` times #4's tall build against
its narrow build in turns at shapes both take (``tall_table``).

Tolerances. Forward (molecule and crystal kernels, per-layer kernel's out
and geometry): rtol 1e-4, atol 1e-5: the kernels sum their products (three
TF32 passes on the tensor cores, accumulated in f32) in another order than
cuBLAS (TF32 off) and carry the difference through 7 to 11 LayerNormed
layers; the per-layer kernel's attention probabilities: rtol 1e-4, atol
1e-6. Backward: pred as the forward; each gradient within 1e-4 x its max
|plain|, since FP32 sums over up to 196,608 rows run in another order; the
kernels' tensor-core products within 2e-6 x max |exact| of a float64
product, where a single TF32 pass reads about 3e-4. Training:
3-step and single-step losses to 1e-4 relative; the two-epoch runs' losses
to 1e-3 relative, since Adam carries the FP32 differences through 16 steps.
bf16 (phase 14): a kernel's mean difference from its bf16 plain version at
most 0.1 x the plain version's bf16-vs-f32 mean difference, or 2 x the
f32-noise floor where that is larger (at full width, f32 sums in another
order alone flip enough bf16 roundings to move the result by 0.04-0.05 x
that gap for #1 with one layer, 0.18-0.30 x for #3 with one layer and
0.35-0.76 x at full depth: the plain version against itself with f64
arithmetic between the roundings, which the phase prints), and there also
at most 0.5 x (one layer) or 0.9 x (full depth) the f32 kernel's distance
from the bf16 plain version; at the full-depth shapes every output within
rtol 0.05 / atol 0.02 (JAX's own bf16 bound) of the same kernel in f32.
bf16 training (phase 15): readings (a)-(d) as above; (a) at most the larger
of 0.1 x (b) and 2 x (c), and at most 0.5 x (d) with one layer and on the
small matrix, 0.9 x (d) at full depth; the bf16 gradient's cosine with the
f32 kernel's above 0.999 (the JAX package's own check,
tests/test_kernels.py:273).
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5
ATTN_ATOL = 1e-6             # attention probabilities of the per-layer kernel
GRAD_RTOL = 1e-4             # of each gradient's max |plain|
MMA_RTOL = 2e-6              # split-TF32 products, of max |float64 product|
LOSS_RTOL = 1e-4
TRAIN_RTOL = 1e-3            # two epochs, kernel against plain step
RATE_LIMIT = 1.05            # a measured rate over 105% of its published peak: a bad probe
# blocks per structure at which phases 17-19 hold the tall and wide #3 (beside
# the wrapper's own choice, kloop.forward_cluster)
HOLD_CLUSTERS = (1, 2, 4, 8, 16)


def held_sizes(i, n):
    """The sizes of ``HOLD_CLUSTERS`` at which the i-th of a phase's n holds
    of one build holds #3, beside the wrapper's own choice: round robin, so
    that the phase holds the build at every size without holding every
    shape at all of them."""
    k = len(HOLD_CLUSTERS)
    if n >= k:
        return (HOLD_CLUSTERS[i % k],)
    return tuple(c for j, c in enumerate(HOLD_CLUSTERS) if j % n == i % n)

# The H100 SXM's published rates (utils/flops.py's table), which the bounds
# use; ``MEASURED`` holds the rates the roofline phase measures on this card,
# which ``bound_ms`` also applies to the same work (``measured_bound_ms``).
H100 = "NVIDIA H100 80GB HBM3"
MEASURED = {}


def published_rates():
    """(FP32 FLOP/s, TF32 FLOP/s, HBM bytes/s, expf/s, BF16 FLOP/s) of the
    H100 SXM."""
    from scann_tpu_torch.utils import flops

    return (flops.peak_fp32_tflops(H100) * 1e12, flops.peak_tflops(H100) * 1e12,
            flops.peak_hbm_bytes_s(H100), flops.peak_exp_per_s(H100),
            flops.peak_bf16_tflops(H100) * 1e12)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def synthetic_batch(rng, B, M, N, use_ring=False, cgcnn=False, n_atoms=10,
                    min_atoms=3):
    """Random valid padded inputs: ragged atom and neighbour counts."""
    counts = rng.integers(min_atoms, M + 1, size=B)
    x = {"atomic": np.zeros((B, M), np.int32),
         "atom_mask": np.zeros((B, M, 1), np.float32),
         "neighbors": np.zeros((B, M, N), np.int32),
         "neighbor_mask": np.zeros((B, M, N), np.float32),
         "neighbor_weight": np.zeros((B, M, N), np.float32),
         "neighbor_distance": np.zeros((B, M, N), np.float32)}
    for b, na in enumerate(counts):
        x["atomic"][b, :na] = rng.integers(1, n_atoms, size=na)
        x["atom_mask"][b, :na, 0] = 1.0
        for m in range(na if na > 1 else 0):   # a lone atom has no neighbours
            k = rng.integers(1, min(N, na) + 1)
            x["neighbors"][b, m, :k] = rng.integers(0, na, size=k)
            x["neighbor_mask"][b, m, :k] = 1.0
            x["neighbor_weight"][b, m, :k] = rng.uniform(0.3, 3.0, size=k)
            x["neighbor_distance"][b, m, :k] = rng.uniform(0.8, 4.0, size=k)
    if use_ring:
        x["ring_aromatic"] = (rng.integers(0, 2, size=(B, M, 2))
                              * x["atom_mask"]).astype(np.float32)
    if cgcnn:
        x["atomic"] = ((rng.uniform(size=(B, M, 92)) < 0.05)
                       * x["atom_mask"]).astype(np.float32)
    return {k: torch.from_numpy(v).cuda() for k, v in x.items()}


def pack_batch(x, capacity, segments=8):
    """A padded batch on the card bin-packed into slots of ``capacity`` rows
    (``data/packing.pack_padded_inputs``, structure packing), its one-hot
    widened to ``segments`` columns: every slot with fewer structures has
    empty segments, and the batch has at least one."""
    from scann_tpu_torch.data.packing import pack_padded_inputs

    p = pack_padded_inputs({k: v.cpu().numpy() for k, v in x.items()}, capacity=capacity,
                           max_segments=segments)
    out = dict(p.inputs)
    slots, used = p.indices.shape
    out["segment_onehot"] = np.concatenate(
        [out["segment_onehot"], np.zeros((slots, capacity, segments - used), np.float32)], -1)
    out["segment_mask"] = np.concatenate(
        [out["segment_mask"], np.zeros((slots, segments - used), np.float32)], -1)
    if out["segment_mask"].all():
        raise AssertionError("a packed batch without an empty segment")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in out.items()}


def packed_label(x):
    """' packed S=..' for a packed batch, '' otherwise."""
    seg = x.get("segment_onehot")
    if seg is None:
        return ""
    empty = int((x["segment_mask"] == 0).sum())
    return f" packed S={seg.shape[-1]} ({empty} empty segments)"


def errors(got, want):
    diff = (got - want).abs()
    ok = bool((diff <= ATOL + RTOL * want.abs()).all()) and bool(torch.isfinite(got).all())
    rel = (diff / want.abs().clamp_min(1e-30)).max().item()
    return diff.max().item(), rel, ok


def cuda_times(fn, reps=25, warmup=3):
    """Per-call CUDA-event times after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times


def cuda_ms(fn, reps=25):
    """Median of per-call CUDA-event times after a warm-up."""
    return statistics.median(cuda_times(fn, reps))


def in_turns_ms(plain, kernel, plain_reps=5, kernel_reps=10):
    """(kernel ms, plain ms): medians over two rounds each, taken in the
    order plain, kernel, kernel, plain, so that a drift of the card's clock
    falls on both alike."""
    p = cuda_times(plain, plain_reps, warmup=2)
    k = cuda_times(kernel, kernel_reps) + cuda_times(kernel, kernel_reps, warmup=0)
    p += cuda_times(plain, plain_reps, warmup=0)
    return statistics.median(k), statistics.median(p)


def back_to_back_ms(fn, reps=20):
    """ms per call of ``reps`` calls between two CUDA events after a warm-up:
    the device's time, the host's work of each call hidden behind the calls
    before it (``cuda_times`` waits for each call, so it counts that work
    where the device is faster than the host)."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def benzene():
    ang = np.deg2rad(np.arange(6) * 60.0)
    c = np.stack([1.39 * np.cos(ang), 1.39 * np.sin(ang), np.zeros(6)], 1)
    h = np.stack([2.47 * np.cos(ang), 2.47 * np.sin(ang), np.zeros(6)], 1)
    return ["C"] * 6 + ["H"] * 6, np.concatenate([c, h]).tolist()


MOLECULES = {  # name -> (species, cartesian coordinates in Angstrom)
    "water": (["O", "H", "H"],
              [[0.0, 0.0, 0.1173], [0.0, 0.7572, -0.4692], [0.0, -0.7572, -0.4692]]),
    "methane": (["C", "H", "H", "H", "H"],
                [[0, 0, 0], [0.6291, 0.6291, 0.6291], [-0.6291, -0.6291, 0.6291],
                 [-0.6291, 0.6291, -0.6291], [0.6291, -0.6291, -0.6291]]),
    "ethanol": (["C", "C", "O", "H", "H", "H", "H", "H", "H"],
                [[1.1879, -0.3829, 0.0], [0.0, 0.5526, 0.0], [-1.1867, -0.2472, 0.0],
                 [-1.9237, 0.385, 0.0], [2.0985, 0.2306, 0.0], [1.1184, -1.0093, 0.8869],
                 [1.1184, -1.0093, -0.8869], [0.0227, 1.1812, 0.8852],
                 [0.0227, 1.1812, -0.8852]]),
    "benzene": benzene(),
}


SCHEDULES = ("f32", "bf16", "recompute")


def schedules(c):
    """A backward launcher's launches by schedule (``kbwd.count_launch``):
    with the f32 stash, with the bf16 stash, and the recompute schedule's."""
    return {"f32": c.stash_launches, "bf16": c.bf16_stash_launches,
            "recompute": c.launches - c.stash_launches - c.bf16_stash_launches}


def mode_counts(c):
    """``schedules(c)`` as one line."""
    n = schedules(c)
    return (f"{c.launches} ({n['f32']} with the f32 stash, {n['bf16']} with the bf16 stash, "
            f"{n['recompute']} recompute)")


def grad_errors(got, want):
    """(worst |got - want| / max |want| over the gradient tensors, its key,
    the largest absolute difference)."""
    worst, where, ab = 0.0, None, 0.0
    for k, w in want.items():
        d = (got[k] - w).abs().max().item()
        rel = d / max(w.abs().max().item(), 1e-30)
        ab = max(ab, d)
        if rel > worst or where is None:
            worst, where = rel, k
    return worst, where, ab


def hold_backward(label, what, got_p, want_p, got_g, want_g, line, failures):
    """Hold one backward launch against its plain version: pred (when
    given) at RTOL / ATOL, each gradient within GRAD_RTOL x its max |plain|.
    Appends to the printed ``line`` and to ``failures``; returns the largest
    absolute difference."""
    worst = 0.0
    if got_p is not None:
        worst, _, ok = errors(got_p, want_p)
        line.append(f"{what} pred {worst:.2e}")
        if not ok:
            failures.append(f"{label} {what} pred: max_abs {worst:.3e}")
    if set(got_g) != set(want_g):
        failures.append(f"{label} {what}: gradient keys differ")
        return worst
    rel, key, ab = grad_errors(got_g, want_g)
    finite = all(bool(torch.isfinite(v).all()) for v in got_g.values())
    line.append(f"{what} grads worst {rel:.2e} of max|plain| at {key}")
    if rel > GRAD_RTOL or not finite:
        failures.append(f"{label} {what}: gradient {key} off by {rel:.3e} of its max "
                        f"(limit {GRAD_RTOL}), finite={finite}")
    return max(worst, ab)


def hold_loop_backward(label, cfm, p, x, y, mrelu, rate, seed, failures, ct=None, relaunches=0,
                       clusters=None):
    """Hold the crystal loop-backward kernel against its plain version on one
    batch, at every cluster size of ``clusters`` (blocks per structure; the
    wrapper's own choice for this batch size when None): in one-shot mode,
    and in cotangent mode when ``ct`` = (d pred, d ga) is given. With
    ``relaunches``, that many further one-shot launches run at each cluster
    size on a kept scratch (as a Trainer keeps its scratch from step to step)
    that is filled with NaN before one launch and with a finite constant
    before the next: each must return the first launch's pred and gradients
    bit for bit, so a race, or a read of scratch that the launch itself did
    not write, fails here. Prints one line per cluster size; returns the
    largest absolute difference from the plain version."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    S = kfwd.segment_count(x)
    chunk_atoms, block, _ = kloop.backward_plan(cfm, M, N, S)
    own = kloop.cluster_size(B)
    packed = kfwd.pack_params(p, cfm)
    pred0, g0 = kloop.reference_loop_train_grads(p, x, y, cfm, mrelu, rate, seed)
    g2 = kloop.reference_loop_grad(p, x, cfm, ct[0], ct[1], rate, seed) if ct is not None else None
    worst = 0.0
    for C in clusters or (own,):
        tag = (f"{label} B={B} M={M} N={N}{packed_label(x)} (atom block {block}, "
               f"{chunk_atoms} per chunk, {C} blocks per structure) dropout {rate}")
        line = [tag]
        if C == own:    # through the public entry points, which choose C themselves
            pred, g = kloop.loop_scann_train_grads(p, x, y, cfm, mrelu, rate, seed)
        else:
            flat, pred = kloop.launch_loop_backward(packed, x, cfm, y, None, True, mrelu, rate,
                                                    seed, 0, None, C)
            pred, g = pred.view(B, -1), kbwd.grads_from_flat(flat, packed, cfm)
        torch.cuda.synchronize()
        worst = max(worst, hold_backward(tag, "one-shot", pred, pred0, g, g0, line, failures))
        if ct is not None:
            if C == own:
                g1 = kloop.loop_scann_grad(p, x, cfm, ct[0], ct[1], rate, seed)
            else:
                flat, _ = kloop.launch_loop_backward(packed, x, cfm, ct[0], ct[1], False, False,
                                                     rate, seed, 0, None, C)
                g1 = kbwd.grads_from_flat(flat, packed, cfm)
            torch.cuda.synchronize()
            worst = max(worst, hold_backward(tag, "ct_ga", None, None, g1, g2, line, failures))
        if relaunches:
            scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, C, S=S)
            differ = set()
            for i in range(relaunches):
                for t in scratch.values():
                    if t is not None:
                        t.fill_(float("nan") if i % 2 == 0 else -3.0)
                flat, pred_i = kloop.launch_loop_backward(packed, x, cfm, y, None, True, mrelu,
                                                          rate, seed, 0, scratch, C)
                again = kbwd.grads_from_flat(flat, packed, cfm)
                differ |= {k for k in g if not torch.equal(g[k], again[k])}
                if not torch.equal(pred_i.view(B, -1), pred):
                    differ.add("pred")
            line.append(f"{relaunches} launches on NaN- and constant-filled scratch (stash "
                        f"{kloop.scratch_stash_mode(scratch)}) bit-identical: {not differ}")
            if differ:
                failures.append(f"{tag}: launches on the same inputs differ in {sorted(differ)}")
            del scratch
        print("  ".join(line), flush=True)
    return worst


def check_products(failures, card):
    """The three products of csrc/scann_mma.cuh on one block, on seeded
    inputs, against a float64 product (torch.matmul is the yardstick here
    only): a single TF32 pass would be about 3e-4 off, so a result within
    MMA_RTOL shows that all three passes are there."""
    from scann_tpu_torch.kernels import scann_backward as kbwd

    g = torch.Generator().manual_seed(4)
    worst = 0.0
    for rows, K, nc in ((32, 256, 128), (32, 128, 128), (24, 20, 128), (8, 60, 60), (64, 128, 32)):
        a = torch.randn(rows, K, generator=g).cuda()
        w = torch.randn(K, nc, generator=g).cuda()
        y = torch.randn(rows, nc, generator=g).cuda()
        got = kbwd.mma_selftest(a, w, y)
        torch.cuda.synchronize()
        exact = a.double() @ w.double()
        want = (exact, exact, a.double().t() @ y.double(), y.double().sum(0))
        rel = [float((o.double() - e).abs().max() / e.abs().max()) for o, e in zip(got, want)]
        one = float((kbwd.reference_tf32x3_matmul(a, w, passes=1).double() - exact).abs().max()
                    / exact.abs().max())
        worst = max(worst, *rel)
        print(f"products [{rows}, {K}] @ [{K}, {nc}]: x @ W {rel[0]:.2e}, the same from W's "
              f"transpose {rel[1]:.2e}, x^T dy {rel[2]:.2e}, column sums {rel[3]:.2e} of max "
              f"|float64 product| (limit "
              f"{MMA_RTOL}; one TF32 pass alone: {one:.2e})", flush=True)
        if not all(r <= MMA_RTOL for r in rel):
            failures.append(f"split-TF32 products at [{rows}, {K}] @ [{K}, {nc}]: {rel}")
    print(f"products: worst {worst:.3e} of max |exact|  [{card}]", flush=True)


def time_backward(cfm, params, packed, inputs, card):
    """Phase 3 for the backward kernel: its launch plus the row reduction at
    the QM9 training shape (dropout 0.1, one-shot), against its bound and
    its plain version (the eager training forward under torch.autograd)."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd

    B, M = inputs["atomic"].shape
    N = inputs["neighbors"].shape[2]
    S = max(kfwd.segment_count(inputs), 1)
    y = torch.from_numpy(np.random.default_rng(1).normal(size=(B, S)).astype(np.float32)).cuda()
    kfwd._check_inputs(inputs, cfm, packed["wde"].device)
    ms, plain_ms = in_turns_ms(
        lambda: kbwd.reference_fused_scann_train_grads(params, inputs, y, cfm, False, 0.1, 7),
        lambda: kbwd._launch(packed, inputs, cfm, y, None, True, False, 0.1, 7, 0, None), 5, 12)
    flops = kbwd.backward_flops(cfm, B, M, N)
    recompute = kbwd.recompute_flops(cfm, B, M, N)
    _, P = kbwd.grad_layout(packed)
    nbytes = (sum(t.numel() * t.element_size() for t in inputs.values())
              + sum(t.numel() * t.element_size() for t in packed.values())
              + 4 * B * S + 4 * (P + B * S))  # targets in; gradients and pred out
    bound, by, measured = bound_ms(flops, nbytes, kbwd.backward_fp32_flops(cfm, B, M, N))
    print(f"scann_backward at B={B} M={M} N={N}{packed_label(inputs)} (the recompute schedule; "
          f"dropout 0.1, one-shot, with its row "
          f"reduction; timed in turns: plain, kernel, kernel, plain): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {flops:.4e} FLOP, "
          f"{nbytes} bytes, bound {bound:.4f} ms ({100 * bound / ms:.1f}% of it reached)  "
          f"[{card}]", flush=True)
    print(f"scann_backward: the kernel's schedule adds {recompute:.4e} FLOP of recompute "
          f"({operations_ms(recompute, 0):.4f} ms as split-TF32 products), which the bound "
          f"does not count", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "flops": flops,
            "recompute_flops": recompute, "bound_by": by, "measured_bound_ms": measured}


def phase4(matrix, qm9_model, qm9_inputs, packed_qm9, failures, card):
    """The backward kernel (one-shot and with a GA cotangent) and the
    forward kernel with dropout against their plain versions, on the same
    Philox masks, unpacked and packed (the small matrix in slots of 16 rows,
    QM9 at the derived packing capacity 32). Returns the largest absolute
    errors."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(4)
    prng = np.random.default_rng(40)       # the packed batches' draws
    err = {"backward": 0.0, "forward_dropout": 0.0}
    cases = [(name, cfm, mrelu, 8, 16, 8, 3) for name, cfm, mrelu in matrix]
    cases += [("scann+ use_drop", dataclasses.replace(matrix[0][1], use_drop=True),
               False, 8, 16, 8, 3),
              ("qm9 width N=24 (one atom per chunk)", qm9_model, False, 8, 32, 24, 3),
              ("qm9 width single atoms", qm9_model, False, 8, 8, 8, 1)]
    for name, cfm, mrelu, B, M, N, min_atoms in cases:
        x = synthetic_batch(rng, B, M, N, cfm.use_ring, cfm.feature == "cgcnn",
                            min_atoms=min_atoms)
        p = init_params(cfm, torch.Generator().manual_seed(2), "cuda")
        for x, r in ((x, rng), (pack_batch(x, 2 * M), prng)) if (M, N) == (16, 8) else ((x, rng),):
            B, M = x["atom_mask"].shape[:2]
            S = max(kfwd.segment_count(x), 1)
            y = torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda()
            ctp = torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda()
            ctg = torch.from_numpy(r.normal(size=(B, M, 1)).astype(np.float32)).cuda()
            for rate in (0.0, 0.1):
                check_backward(f"{name}{packed_label(x)} dropout {rate}", cfm, p, x, y, ctp, ctg,
                               mrelu, rate, err, failures)
    for label, x in (("qm9 full width", qm9_inputs),
                     ("qm9 full width capacity 32", packed_qm9[32])):
        p = init_params(qm9_model, torch.Generator().manual_seed(3), "cuda")
        B = x["atomic"].shape[0]
        r = prng if kfwd.segment_count(x) else rng
        y = torch.from_numpy(r.normal(size=(B, max(kfwd.segment_count(x), 1)))
                             .astype(np.float32)).cuda()
        check_backward(f"{label}{packed_label(x)} dropout 0.1", qm9_model, p, x, y, None, None,
                       False, 0.1, err, failures)
    print(f"phase 4: worst backward abs error {err['backward']:.3e}, forward with dropout "
          f"{err['forward_dropout']:.3e}  [{card}]", flush=True)
    return err


def check_backward(label, cfm, p, x, y, ctp, ctg, mrelu, rate, err, failures):
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd

    seed = 11
    with torch.no_grad():
        pf, gf = kfwd.fused_scann_forward(p, x, cfm, mrelu, rate, seed)
        torch.cuda.synchronize()
        pr, gr = kfwd.reference_scann_forward(p, x, cfm, mrelu, rate, seed)
    line = [label]
    for what, got, want in (("fwd pred", pf, pr), ("fwd ga", gf, gr)):
        ab, _, ok = errors(got, want)
        err["forward_dropout"] = max(err["forward_dropout"], ab)
        line.append(f"{what} {ab:.2e}")
        if not ok:
            failures.append(f"{label} {what}: max_abs {ab:.3e} outside rtol {RTOL} atol {ATOL}")
    pred, g = kbwd.fused_scann_train_grads(p, x, y, cfm, mrelu, rate, seed)
    torch.cuda.synchronize()
    pred0, g0 = kbwd.reference_fused_scann_train_grads(p, x, y, cfm, mrelu, rate, seed)
    checks = [("one-shot", pred, pred0, g, g0)]
    if ctp is not None:
        g1 = kbwd.fused_scann_grad(p, x, cfm, ctp, ctg, rate, seed)
        torch.cuda.synchronize()
        checks.append(("ct_ga", None, None, g1,
                       kbwd.reference_fused_scann_grad(p, x, cfm, ctp, ctg, rate, seed)))
    for what, got_p, want_p, got_g, want_g in checks:
        err["backward"] = max(err["backward"], hold_backward(label, what, got_p, want_p, got_g,
                                                             want_g, line, failures))
    print("  ".join(line), flush=True)


def bucket_losses(trainer, buckets):
    """RMSE + l2 of the trainer's current weights on each bucket, without
    dropout (the forward kernels). The launch counters and the trainer's
    counting wrapper are left as they were."""
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import l2_penalty

    counters = (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)
    saved = [c.launches for c in counters]
    wrapper = trainer.__dict__.pop("forward_eval", None)
    l2 = float(l2_penalty(trainer.params, trainer.config.hyper.l2_reg))
    out = []
    for b, dev in zip(buckets, trainer._put_buckets(buckets, "train")):
        _, _, pred, y = trainer._evaluate_buckets([b], [dev])
        out.append(float(np.sqrt(np.mean((pred - y) ** 2))) + l2)
    if wrapper is not None:
        trainer.forward_eval = wrapper
    for c, n in zip(counters, saved):
        c.launches = n
    return out


def trace_passes(trainer, buckets):
    """Record every bucket's loss without dropout as each pass over one
    bucket begins (``epoch_plan`` is called once per pass); returns the
    list of (epoch, bucket, losses) it fills."""
    passes, plan = [], trainer.epoch_plan

    def traced(epoch, bucket, n_rows, batch_size):
        passes.append((epoch, bucket, bucket_losses(trainer, buckets)))
        return plan(epoch, bucket, n_rows, batch_size)

    trainer.epoch_plan = traced
    return passes


def check_passes(label, passes, final, failures, phase="phase 5"):
    """Prints what every pass did to every bucket's loss without dropout
    and, unless ``failures`` is None, holds each pass to lowering the loss
    of its own bucket."""
    ends = [p[2] for p in passes[1:]] + [final]
    for (epoch, bucket, before), after in zip(passes, ends):
        moves = ", ".join(f"bucket {j} {x:.6f} -> {y:.6f}"
                          for j, (x, y) in enumerate(zip(before, after)))
        print(f"{phase} {label}: epoch {epoch} pass over bucket {bucket}: {moves}", flush=True)
        if failures is not None and not (np.isfinite(after[bucket])
                                         and after[bucket] < before[bucket]):
            failures.append(f"{label}: the pass over bucket {bucket} in epoch {epoch} did not "
                            f"lower its loss: {before[bucket]} -> {after[bucket]}")


def phase5(qm9_model, failures, card):
    """Train 2 epochs through Scann at QM9 width on synthetic QM9-like
    molecules, in the flagship recipe's two buckets (the main path, whose
    launches it returns), again with the plain step, and in one bucket."""
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.cli import preprocess
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.builders.common import save_dataset
    from scann_tpu_torch.data.featurize import featurize_record
    from scann_tpu_torch.data.synthetic import synthetic_records
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.train.loop import Trainer

    class PlainTrainer(Trainer):
        """The same Trainer with the backward kernel's plain version."""

        def raw_grads(self, batch, y, seed):
            pred, raw = kbwd.reference_fused_scann_train_grads(
                self.params, batch, y, self.config.model, self.mrelu_head,
                self.dropout_rate, seed)
            return pred[:, 0], raw

    work = tempfile.mkdtemp(prefix="scann_chip_smoke_")
    t0 = time.time()
    n_mol, pool = 1000, 8
    energy = save_dataset(synthetic_records("qm9like", n_mol, min_atoms=5, max_atoms=29, seed=0),
                          work, "synthetic")
    t1 = time.time()
    preprocess.main(["synthetic", work, "--p", str(pool)])     # finds the energy file
    pool_s = time.time() - t1
    nbr = os.path.join(work, "synthetic", "synthetic_data_neighbor_dt4.0_wt0.4.npy")
    # the serial featurizer on 128 of the molecules, spread over the file (it is
    # sorted by size): the pool's records must be the same
    records, pooled = (np.load(f, allow_pickle=True) for f in (energy, nbr))
    pick = np.linspace(0, n_mol - 1, 128).astype(int)
    t1 = time.perf_counter()
    serial = [featurize_record(records[i]) for i in pick]
    serial_ms = 1e3 * (time.perf_counter() - t1) / len(pick)
    bad = sum(not same_neighbors(a, b) for a, b in zip(serial, pooled[pick]))
    print(f"phase 5: {n_mol} synthetic molecules (5-29 atoms of H, C, N, O, F) written with "
          f"builders.common.save_dataset, then cli.preprocess featurized them on {pool} "
          f"processes in {pool_s:.2f} s wall ({1e3 * pool_s / n_mol:.3f} ms a molecule, pool "
          f"start-up included); the serial featurize_record {serial_ms:.3f} ms a molecule on "
          f"128 of them; their records differ from the pool's in {bad} of 128; "
          f"{time.time() - t0:.1f} s in all  [{card}]", flush=True)
    if bad or len(pooled) != n_mol:
        failures.append(f"phase 5: the preprocess pool's neighbour records differ from the "
                        f"serial featurizer's in {bad} of 128 molecules")

    def config(name, max_buckets):
        return ScannConfig(model=qm9_model,
                           hyper=HyperConfig(batch_size=128, scheduler="sgdr", lr=5e-4,
                                             min_lr=1e-4, data_energy_path=energy,
                                             data_nei_path=nbr, epochs=2, seed=0,
                                             save_path=os.path.join(work, name)),
                           tpu=TpuConfig(max_buckets=max_buckets))

    # ---- the main path: the flagship recipe's buckets (max_buckets: 2) ----
    cfg = config("run", 2)
    scann = Scann(cfg, device="cuda")
    scann.prepare_dataset()
    buckets = scann.train_buckets
    steps = 2 * sum(-(-b.num_structures // 128) for b in buckets)
    eval_batches = (2 * sum(-(-b.num_structures // 128) for b in scann.valid_buckets)
                    + sum(-(-b.num_structures // 128) for b in scann.test_buckets))
    trainer = scann.trainer
    scann.init_params(cfg.hyper.seed)              # what fit() would draw
    passes = trace_passes(trainer, buckets)
    step_ms, fwd_calls = [], [0]
    train_step, forward_eval = trainer.train_step, trainer.forward_eval

    def timed_step(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = train_step(*args)
        e.record()
        step_ms.append((s, e))
        return out

    def counted_eval(*args):
        fwd_calls[0] += 1
        return forward_eval(*args)

    trainer.train_step, trainer.forward_eval = timed_step, counted_eval
    kbwd.reset_counts(kbwd.launch_scann_backward)    # counts of the training path only
    kfwd.fused_scann_forward.launches = 0
    t1 = time.time()
    hist = scann.train()
    final = bucket_losses(trainer, buckets)        # before evaluate() restores "best"
    result = scann.evaluate()
    torch.cuda.synchronize()
    bwd_launches = kbwd.launch_scann_backward.launches
    fwd_launches = kfwd.fused_scann_forward.launches
    by_schedule = schedules(kbwd.launch_scann_backward)
    print(f"phase 5: #2 launches by schedule {mode_counts(kbwd.launch_scann_backward)}", flush=True)
    if by_schedule["f32"] == 0:
        failures.append("phase 5: no launch of #2 with the f32 keep-acts stash on the main path")
    del trainer.train_step, trainer.forward_eval, trainer.epoch_plan
    med = statistics.median(s.elapsed_time(e) for s, e in step_ms)
    n_train = sum(b.num_structures for b in buckets)
    print(f"phase 5: buckets {[(b.shape, b.num_structures) for b in buckets]}, "
          f"{len(step_ms)} steps in {time.time() - t1:.1f} s, losses {hist['loss']}, "
          f"val_mae {hist['val_mae']}, test {result}", flush=True)
    print(f"phase 5: median train step {med:.4f} ms (CUDA events), epoch 2 "
          f"{n_train / hist['epoch_time'][1]:.1f} structures/s (the per-pass probes "
          f"included); backward launches "
          f"{bwd_launches} for {steps} steps, forward launches {fwd_launches} for "
          f"{eval_batches} eval batches  [{card}]", flush=True)
    if not all(np.isfinite(hist["loss"])):
        failures.append(f"training loss not finite: {hist['loss']}")
    # An epoch trains its buckets one after the other (as the JAX Trainer
    # does), so the loss that falls is that of the bucket being trained.
    check_passes("kernel", passes, final, failures)
    if bwd_launches != steps or len(step_ms) != steps:
        failures.append(f"backward launches {bwd_launches} != training steps {steps}")
    if fwd_launches != eval_batches or fwd_calls[0] != eval_batches:
        failures.append(f"forward launches {fwd_launches} != eval batches {eval_batches}")

    # ---- the same run with the plain step: the same losses -------------------
    plain = PlainTrainer(cfg, "cuda", os.path.join(work, "plain"))
    plain.init_state(cfg.hyper.seed)
    plain_passes = trace_passes(plain, buckets)
    plain_hist = plain.fit(buckets, scann.valid_buckets, log_fn=lambda *_: None)
    plain_final = bucket_losses(plain, buckets)
    check_passes("plain", plain_passes, plain_final, failures)
    mine = hist["loss"] + [x for p in passes for x in p[2]] + final
    ref = plain_hist["loss"] + [x for p in plain_passes for x in p[2]] + plain_final
    rel = max(abs(a - b) / abs(b) for a, b in zip(mine, ref))
    print(f"phase 5: the plain step's run: losses {plain_hist['loss']}; its epoch and "
          f"per-pass losses against the kernel's: max rel {rel:.3e} (limit "
          f"{TRAIN_RTOL})", flush=True)
    if len(mine) != len(ref) or not rel <= TRAIN_RTOL:
        failures.append(f"kernel and plain two-epoch runs differ: {rel:.3e}")

    # 3 steps through the kernel against 3 through the plain step
    b = buckets[-1]
    losses = []
    for cls in (Trainer, PlainTrainer):
        t = cls(cfg, "cuda", os.path.join(work, cls.__name__))
        t.init_state(5)
        (binputs, btargets), = t._put_buckets([b], "train")
        idx, seeds = t.epoch_plan(0, 0, b.num_structures, 128)
        run = []
        for k in range(3):
            rows = idx[k % idx.shape[0]].cuda()
            loss, _ = t.train_step({n: v[rows] for n, v in binputs.items()}, btargets[rows],
                                   5e-4, seeds[k % len(seeds)])
            run.append(float(loss))
        losses.append(run)
    rel = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    print(f"phase 5: 3 kernel steps {losses[0]} vs 3 plain steps {losses[1]}: "
          f"max rel {rel:.3e} (limit {LOSS_RTOL})", flush=True)
    if not rel <= LOSS_RTOL:
        failures.append(f"kernel and plain training steps differ: {rel:.3e}")

    # a model loaded back from the run directory predicts what the trainer does
    p_trained = scann.predict_data(scann.test_buckets)
    loaded = Scann.load_model_infer(trainer.workdir, device="cuda")
    p_loaded = loaded.predict_data(scann.test_buckets)
    d = float(np.abs(p_trained - p_loaded).max())
    print(f"phase 5: load_model_infer predicts {len(p_loaded)} test molecules, max |d| "
          f"{d:.3e} from the trainer's predictions", flush=True)
    if not (np.isfinite(p_loaded).all() and d <= ATOL + RTOL * np.abs(p_trained).max()):
        failures.append(f"load_model_infer predictions differ by {d:.3e}")

    # ---- resume: load_pretrained(<run>/checkpoints/last) on the card ----------
    # One step on the same rows, lr and dropout seed in the trainer put back
    # in the state "last" recorded (evaluate() restored "best" into it) and in
    # a fresh Scann loaded from that checkpoint: both launch kernel #2, whose
    # launches repeat bit for bit, so every tensor must be equal.
    last = os.path.join(trainer.workdir, "checkpoints", "last")
    resumed = Scann(ScannConfig.from_dict(cfg.to_dict()), pretrained=last, device="cuda")
    trainer.restore_checkpoint("last")
    b = buckets[-1]
    idx, seeds = trainer.epoch_plan(cfg.hyper.epochs, len(buckets) - 1, b.num_structures, 128)
    rows = idx[0].cuda()
    lr = cfg.hyper.lr / (1.0 + cfg.hyper.adam_decay * trainer.step)
    for t in (trainer, resumed.trainer):
        (binputs, btargets), = t._put_buckets([b], "resume")
        t.train_step({n: v[rows] for n, v in binputs.items()}, btargets[rows], lr, seeds[0])
    torch.cuda.synchronize()
    pairs = [(getattr(trainer, a), getattr(resumed.trainer, a)) for a in ("params", "mu", "nu")]
    equal = sum(torch.equal(x[k], y[k]) for x, y in pairs for k in x)
    total = sum(len(x) for x, _ in pairs)
    print(f"phase 5: resumed through load_pretrained({os.path.relpath(last, work)}): one step "
          f"at step {trainer.step - 1} in both, {equal} of {total} tensors (params, mu, nu) "
          f"equal, step {resumed.trainer.step} vs {trainer.step}", flush=True)
    if equal != total or resumed.trainer.step != trainer.step:
        failures.append(f"phase 5: the step after load_pretrained(checkpoints/last) differs "
                        f"from the trainer's: {equal} of {total} tensors equal, step "
                        f"{resumed.trainer.step} vs {trainer.step}")

    # ---- one bucket: the epoch loss and the training-set loss fall -----------
    one = Scann(config("one", 1), device="cuda")
    one.prepare_dataset()
    one.init_params(0)
    before = bucket_losses(one.trainer, one.train_buckets)
    one_hist = one.train()
    after = bucket_losses(one.trainer, one.train_buckets)
    n_one = sum(b.num_structures for b in one.train_buckets)
    print(f"phase 5 one bucket {[b.shape for b in one.train_buckets]}: epoch losses "
          f"{one_hist['loss']}, training-set loss without dropout {before[0]:.6f} -> "
          f"{after[0]:.6f}, epoch 2 {n_one / one_hist['epoch_time'][1]:.1f} structures/s  "
          f"[{card}]", flush=True)
    if not (all(np.isfinite(one_hist["loss"])) and one_hist["loss"][-1] < one_hist["loss"][0]
            and np.isfinite(after[0]) and after[0] < before[0]):
        failures.append(f"one-bucket training loss not finite and falling: epochs "
                        f"{one_hist['loss']}, training set without dropout {before} -> {after}")
    return bwd_launches, {"data": (energy, nbr), "work": work, "step_ms": med,
                          "structures_s": n_train / hist["epoch_time"][1], "name": "phase 5",
                          "schedules": by_schedule}


def train_packed(label, cfm, info, capacity, epochs, batch_size, want_routes, failures, card,
                 neighbors_multiple=8, compare_unpacked=False):
    """Structure packing on a training path: ``epochs`` epochs through
    ``Scann.prepare_dataset -> train -> evaluate -> predict_data`` with
    ``tpu.structure_packing`` at ``capacity`` rows a slot (None: derived from
    the largest structure), up to 8 segments a slot, on a featurized set of
    an earlier phase. Checks the routes (eval, step), one launch of the
    step's kernel per step and of the eval kernel per eval batch and none of
    the others, a finite loss that falls over more than one epoch and, with
    ``compare_unpacked``, that ``predict_data`` per structure equals the
    unpacked pipeline's with the same parameters. Returns the launches by
    kernel, and the backward kernels' as ``<kernel>/<schedule>`` too
    (``schedules``)."""
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    energy, nbr = info["data"]
    target = "formation_energy_per_atom" if cfm.n_atoms > 10 else "homo"

    def config(name, packed):
        return ScannConfig(model=cfm,
                           hyper=HyperConfig(batch_size=batch_size, scheduler="sgdr", lr=5e-4,
                                             min_lr=1e-4, target=target, data_energy_path=energy,
                                             data_nei_path=nbr, epochs=epochs, seed=0,
                                             save_path=os.path.join(info["work"], name)),
                           tpu=TpuConfig(max_buckets=2, structure_packing=packed,
                                         packing_capacity=capacity, pack_max_segments=8,
                                         neighbors_pad_multiple=neighbors_multiple))

    scann = Scann(config(label.replace(" ", "_"), True), device="cuda")
    scann.prepare_dataset()
    (b,) = scann.train_buckets
    M, N = b.shape
    S = b.num_segments
    trainer = scann.trainer
    routes = (trainer.eval_route(M, N, S), trainer.train_route(M, N, S))
    scann.init_params(0)
    step_ms = []
    train_step = trainer.train_step

    def timed_step(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = train_step(*args)
        e.record()
        step_ms.append((s, e))
        return out

    trainer.train_step = timed_step
    counters = {"scann_forward": kfwd.fused_scann_forward,
                "scann_backward": kbwd.launch_scann_backward,
                "scann_loop": kloop.launch_loop_forward,
                "scann_loop_backward": kloop.launch_loop_backward,
                "local_attention": kla.fused_local_attention}
    for c in counters.values():
        c.launches = 0                               # counts of this packed path only
    for name in ("scann_backward", "scann_loop_backward"):
        kbwd.reset_counts(counters[name])
    hist = scann.train()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    by_schedule = {f"{k}/{m}": n for k in ("scann_backward", "scann_loop_backward")
                   for m, n in schedules(counters[k]).items()}
    del trainer.train_step
    slot_bs = trainer._slot_batch
    steps = epochs * -(-len(b.targets) // slot_bs)
    evals = epochs * sum(-(-len(v.targets) // slot_bs) for v in scann.valid_buckets)
    result = scann.evaluate()
    med = statistics.median(s.elapsed_time(e) for s, e in step_ms)
    per_s = b.num_structures / hist["epoch_time"][-1]
    print(f"{label}: {b.num_structures} structures in {b.num_slots} slots of {M} rows "
          f"({b.occupancy:.1%} occupancy, S={S}), N={N}, slot batch {slot_bs} (batch_size "
          f"{batch_size} structures); routes eval {routes[0]}, step {routes[1]}; losses "
          f"{hist['loss']}, val_mae {hist['val_mae']}, test {result}", flush=True)
    print(f"{label}: median train step {med:.4f} ms (CUDA events), last epoch {per_s:.1f} "
          f"structures/s; unpacked ({info['name']}): median step {info['step_ms']:.4f} ms, "
          f"epoch 2 {info['structures_s']:.1f} structures/s; launches {launches} for {steps} "
          f"steps and {evals} eval batches  [{card}]", flush=True)
    eval_kernel = {"fused": "scann_forward", "loop": "scann_loop"}.get(routes[0])
    step_kernel = {"fused": "scann_backward", "loop": "scann_loop_backward"}.get(routes[1])
    expect = {k: 0 for k in counters}
    if eval_kernel:
        expect[eval_kernel] += evals
    if step_kernel:
        expect[step_kernel] += steps
    if routes != want_routes or launches != expect or len(step_ms) != steps:
        failures.append(f"{label}: routes {routes} (want {want_routes}), launches {launches} "
                        f"(want {expect}), {len(step_ms)} timed steps for {steps}")
    if not (all(np.isfinite(hist["loss"])) and (epochs == 1 or hist["loss"][-1] < hist["loss"][0])):
        failures.append(f"{label}: training loss not finite and falling: {hist['loss']}")
    if compare_unpacked:
        got, got_ga = scann.predict_data(scann.test_buckets, with_ga=True)
        plain = Scann(config(label.replace(" ", "_") + "_unpacked", False), device="cuda")
        plain.prepare_dataset()
        plain.trainer.load_params(scann.params)
        want, want_ga = plain.predict_data(plain.test_buckets, with_ga=True)
        d = float(np.abs(got - want).max())
        d_ga = max(float(np.abs(g - w).max()) for g, w in zip(got_ga, want_ga))
        ok = (got.shape == want.shape and np.isfinite(got).all()
              and np.all(np.abs(got - want) <= ATOL + RTOL * np.abs(want))
              and all(g.shape == w.shape and np.all(np.abs(g - w) <= ATOL + RTOL * np.abs(w))
                      for g, w in zip(got_ga, want_ga)))
        print(f"{label}: predict_data of {len(got)} test structures packed against unpacked, "
              f"same parameters: max |d| {d:.3e}, GA scores {d_ga:.3e} (rtol {RTOL}, atol "
              f"{ATOL})", flush=True)
        if not ok:
            failures.append(f"{label}: packed predictions differ from unpacked: {d:.3e}, "
                            f"ga {d_ga:.3e}")
    return {**launches, **by_schedule}


def operations_ms(flops, fp32_flops, rates=None, bf16=False):
    """The least time of ``flops`` (``utils.flops.operations_seconds``):
    ``fp32_flops`` of them at the FP32 rate outside the tensor cores and the
    rest as split-TF32 products, three TF32 passes each at the dense TF32
    rate, or with ``bf16`` (the bf16 operand mode) once each at the dense
    BF16 rate; at the published rates, or at ``rates``
    (``measure_device_rates``'s) when given."""
    from scann_tpu_torch.utils.flops import operations_seconds

    return 1e3 * operations_seconds(flops, fp32_flops, bf16, rates, H100)


def bound_ms(flops, nbytes, fp32_flops, bf16=False):
    """(bound, "operations" | "bytes", measured bound): the larger of the
    operations' time (``operations_ms``) and the HBM time of one pass over
    inputs and outputs, at the published rates; the same at the rates the
    roofline phase measured (None before it ran)."""
    ops_ms = operations_ms(flops, fp32_flops, bf16=bf16)
    bytes_ms = 1e3 * nbytes / published_rates()[2]
    measured = None
    if MEASURED:
        measured = max(operations_ms(flops, fp32_flops, MEASURED, bf16),
                       1e3 * nbytes / (MEASURED["hbm_gbps"] * 1e9))
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", measured


def tensor_bytes(*groups):
    return sum(t.numel() * t.element_size() for g in groups for t in g if t is not None)


def weights(packed):
    """The weights of a ``pack_params`` dict, which a bound counts once:
    without the TF32 planes made from them (``kfwd.tf32_planes``)."""
    return [t for k, t in packed.items() if k != "tf32_planes"]


def hold(label, named, failures):
    """Print one line of max abs errors for (what, got, want, atol) and
    record what falls outside rtol/atol; returns the largest error."""
    line, worst = [label], 0.0
    for what, got, want, atol in named:
        diff = (got - want).abs()
        ok = (bool((diff <= atol + RTOL * want.abs()).all())
              and bool(torch.isfinite(got).all()))
        ab = diff.max().item()
        worst = max(worst, ab)
        line.append(f"{what} {ab:.2e}")
        if not ok:
            failures.append(f"{label} {what}: max_abs {ab:.3e} outside rtol {RTOL} atol {atol}")
    print("  ".join(line), flush=True)
    return worst


def qm9_config():
    """The QM9 model at its published width (configs/model_qm9.yaml)."""
    from scann_tpu_torch.config import ModelConfig

    return ModelConfig(n_atoms=10, embedding_dim=48, n_attention=7, local_dim=128, num_head=8,
                       global_dim=128, dense_out=128, scale=0.5, use_attn_norm=True,
                       use_ga_norm=True, use_ring=False, g_update=True, gaussian_d=4.0)


def crystal_models():
    """configs/model_mp2018.yaml and configs/model_ptgp.yaml, model blocks."""
    from scann_tpu_torch.config import ModelConfig

    wide = dict(local_dim=128, num_head=8, global_dim=128, dense_out=128, scale=0.5,
                use_attn_norm=True, use_ga_norm=True)
    mp2018 = ModelConfig(n_atoms=95, embedding_dim=128, n_attention=9, use_ring=False,
                         g_update=True, gaussian_d=6.0, **wide)
    ptgp = ModelConfig(n_atoms=80, embedding_dim=48, n_attention=11, use_ring=True,
                       g_update=False, gaussian_d=4.0, **wide)
    return mp2018, ptgp


def hold_loop_forward(label, cfm, p, x, failures, mrelu=False, rate=0.0, clusters=None,
                      relaunches=0):
    """Hold the crystal loop-forward kernel against its plain version on one
    batch, at every cluster size of ``clusters`` (blocks per structure) and
    at the wrapper's own choice for this batch (``kloop.forward_cluster``),
    which runs through the public entry point. With ``relaunches``, that
    many further launches run at each cluster size on a kept scratch
    (geometry, centers, readout rows, keys) filled with NaN before one
    launch and with a finite constant before the next: each must return the
    first launch's pred and ga bit for bit. Returns the largest absolute
    difference from the plain version."""
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    S = kfwd.segment_count(x)
    chunk_atoms, block, _, _ = kloop.forward_plan(cfm, M, N, S)
    own = kloop.forward_cluster(cfm, B, M, N, S)
    packed = kfwd.pack_params(p, cfm)
    with torch.inference_mode():
        pred0, ga0 = kloop.reference_loop_forward(p, x, cfm, mrelu, rate, 11)
    worst = 0.0
    for C in sorted(set(clusters or ()) | {own}):
        tag = (f"{label} B={B} M={M} N={N}{packed_label(x)} (atom block {block}, "
               f"{chunk_atoms} per chunk, {C} blocks per structure) dropout {rate}")
        with torch.inference_mode():
            if C == own:    # through the public entry point, which chooses C itself
                pred, ga = kloop.loop_scann_forward(p, x, cfm, mrelu, rate, 11)
            else:
                pred, ga = kloop._launch(packed, x, cfm, mrelu, rate, 11, 0, C)
            torch.cuda.synchronize()
        worst = max(worst, hold(tag, [("pred", pred, pred0, ATOL), ("ga", ga, ga0, ATOL)],
                                failures))
        if relaunches:
            scratch = kloop.loop_forward_scratch(cfm, B, M, N, x["atomic"].device, C,
                                                 kfwd.segment_count(x))
            differ = set()
            with torch.inference_mode():
                for i in range(relaunches):
                    for t in scratch.values():
                        if t is not None:
                            t.fill_(float("nan") if i % 2 == 0 else -3.0)
                    p_i, g_i = kloop._launch(packed, x, cfm, mrelu, rate, 11, 0, C, scratch)
                    differ |= {w for w, a, b in (("pred", p_i, pred), ("ga", g_i, ga))
                               if not torch.equal(a, b)}
            print(f"{tag}: {relaunches} launches on NaN- and constant-filled scratch "
                  f"bit-identical: {not differ}", flush=True)
            if differ:
                failures.append(f"{tag}: launches on the same inputs differ in {sorted(differ)}")
    return worst


def time_loop_forward(name, cfm, x, card, clusters=(None,), plain=True):
    """Kernel #3 at one batch shape, at each cluster size of ``clusters`` (None:
    the wrapper's own, ``kloop.forward_cluster``), in turns with its plain
    version (plain, kernel, kernel, plain; without ``plain``, 10 timed
    launches after 3 and no plain time), against its bound: the larger of
    the operations' time (``operations_ms``) and the HBM time of the inputs,
    weights and outputs read or written once plus the geometry scratch's
    round trips (``loop_forward_bytes``). Returns {C: timing}."""
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    params = init_params(cfm, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(params, cfm)
    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    flops = kloop.loop_forward_flops(cfm, B, M, N)
    nbytes = (tensor_bytes(x.values(), weights(packed)) + 4 * (B + B * M)
              + kloop.loop_forward_bytes(cfm, B, M, N))
    bound, by, measured = bound_ms(flops, nbytes, kfwd.forward_fp32_flops(cfm, B, M, N))
    out = {}
    with torch.inference_mode():
        kloop.check_supported(cfm, M, N)
        kfwd._check_inputs(x, cfm, packed["wde"].device)
        for C in clusters:
            C = kloop.forward_cluster(cfm, B, M, N) if C is None else C
            scratch = kloop.loop_forward_scratch(cfm, B, M, N, x["atomic"].device, C,
                                                 kfwd.segment_count(x))
            run = lambda: kloop._launch(packed, x, cfm, False, 0.0, 0, 0, C, scratch)
            if plain:
                ms, plain_ms = in_turns_ms(
                    lambda: kloop.reference_loop_forward(params, x, cfm), run, 3, 10)
            else:
                ms, plain_ms = cuda_ms(run, 10), None
            how = "timed in turns: plain, kernel, kernel, plain" if plain else "10 launches"
            print(f"scann_loop ({kloop.forward_library(cfm, M, N)[0]}) at {name} B={B} M={M} "
                  f"N={N} L={cfm.n_attention} ({how}): kernel {ms:.4f} ms on {B} clusters of "
                  f"{C} blocks ({kloop.max_active_forward_clusters(cfm, B, M, N, C)} such "
                  f"clusters run at once), plain "
                  f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
                  f"{flops:.4e} FLOP, {nbytes} bytes, bound {bound:.4f} ms by {by} "
                  f"({100 * bound / ms:.1f}% of it reached)  [{card}]", flush=True)
            out[C] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                      "measured_bound_ms": measured, "flops": flops, "cluster": C}
    return out


def time_forward_batches(name, cfm, batch, card):
    """#3 alone at B = 1 and at the recipe batch of 64 of one shape
    (``batch(B)`` makes the inputs), each at the wrapper's own cluster size
    (``kloop.forward_cluster``: 16 blocks for one structure in the tall and
    wide builds, 2 at 64), 10 timed launches after 3 (``time_loop_forward``
    without its plain version): the ``b1_*`` and ``recipe_*`` keys of a
    kernels-line row."""
    out = {}
    for B, tag in ((1, "b1"), (64, "recipe")):
        x = batch(B)
        t = next(iter(time_loop_forward(name, cfm, x, card, plain=False).values()))
        del x
        out.update({f"{tag}_{k}": t[k] for k in ("ms", "bound_ms", "measured_bound_ms",
                                                 "cluster")})
    return out


def phase6(matrix, mp2018, ptgp, mp_packed, failures, card):
    """The crystal loop-forward kernel against its plain version at 1, 2 and
    4 blocks per structure (a small matrix at dropout 0 and 0.1, two atoms
    per chunk, a one-atom structure, fewer atoms than blocks, a ragged
    M = 160 at B <= 28, atom blocks of 16 at M = 200, the gate's edge
    M = 237, MP2018 at B = 64 and 128, Pt/graphene), with relaunches on
    garbage-filled scratch held bit for bit, then its time. Returns (largest
    abs error, timing of the MP2018 shape)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(6)
    worst = 0.0
    every = kloop.CLUSTER_SIZES[::-1]      # (1, 2, 4)

    def compare(name, cfm, x, mrelu=False, rate=0.0, clusters=every, relaunches=0):
        nonlocal worst
        p = init_params(cfm, torch.Generator().manual_seed(6), "cuda")
        worst = max(worst, hold_loop_forward(f"phase 6 {name}", cfm, p, x, failures, mrelu, rate,
                                             clusters, relaunches))

    cases = list(matrix) + [("scann+ use_drop", dataclasses.replace(matrix[0][1], use_drop=True),
                             False)]
    for name, cfm, mrelu in cases:
        # M=40: an atom block of 32 and one of 8 at one block per structure, shares of 20
        # and 10 at 2 and 4; single-atom structures allowed
        x = synthetic_batch(rng, 6, 40, 8, cfm.use_ring, cfm.feature == "cgcnn", min_atoms=1)
        compare(name, cfm, x, mrelu, 0.0)
        compare(name, cfm, x, mrelu, 0.1, relaunches=2)
    compare("scann+ two atoms per chunk", matrix[0][1], synthetic_batch(rng, 4, 72, 24))
    lone = synthetic_batch(rng, 4, 72, 8)
    lone["atom_mask"][0] = 0.0
    lone["atom_mask"][0, 0] = 1.0
    lone["neighbor_mask"][0] = 0.0
    compare("scann+ one-atom structure", matrix[0][1], lone, relaunches=2)
    # M=3 at 4 blocks per structure: the last block has no atom
    compare("scann+ fewer atoms than blocks", matrix[0][1],
            synthetic_batch(rng, 4, 3, 8, min_atoms=1), rate=0.1, relaunches=2)
    # a small batch (4 blocks per structure) of a ragged bucket, atom blocks of 16
    # (M 189 to 221) and the gate's edge (blocks of 8)
    compare("mp2018 full width, ragged", mp2018,
            synthetic_batch(rng, 20, 160, 32, n_atoms=mp2018.n_atoms), rate=0.1, relaunches=4)
    compare("mp2018 full width, atom blocks of 16", mp2018,
            synthetic_batch(rng, 4, 200, 32, n_atoms=mp2018.n_atoms, min_atoms=150),
            relaunches=4)
    compare("mp2018 full width, the gate's edge", mp2018,
            synthetic_batch(rng, 4, 237, 32, n_atoms=mp2018.n_atoms, min_atoms=150),
            relaunches=4)
    mp_inputs = synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20)
    compare("mp2018 full width", mp2018, mp_inputs, clusters=(1, 2), relaunches=4)
    twice = {k: torch.cat([v, v]) for k, v in mp_inputs.items()}
    compare("mp2018 full width", mp2018, twice, clusters=(1,))
    ptgp_inputs = synthetic_batch(rng, 64, 128, 32, use_ring=True, n_atoms=ptgp.n_atoms,
                                  min_atoms=20)
    compare("ptgp full width", ptgp, ptgp_inputs, clusters=(1, 2), relaunches=4)
    # packed slots: the small matrix in slots of 16 rows, and MP2018-like crystals of
    # 20-90 sites at packing capacity 96, up to 8 segments a slot, at 1, 2 and 4 blocks
    prng = np.random.default_rng(60)
    for name, cfm, mrelu in matrix:
        compare(f"{name}", cfm, pack_batch(synthetic_batch(prng, 12, 8, 8, cfm.use_ring,
                                                           cfm.feature == "cgcnn"), 16),
                mrelu, 0.1, relaunches=2)
    compare("mp2018 full width capacity 96", mp2018, mp_packed, relaunches=4)

    mp = time_loop_forward("mp2018", mp2018, mp_inputs, card, clusters=(2, 1))
    timing = dict(mp[2], ms_one_block=mp[1]["ms"])
    (doubled,) = time_loop_forward("mp2018, the batch doubled", mp2018, twice, card).values()
    (pt,) = time_loop_forward("ptgp", ptgp, ptgp_inputs, card).values()
    timing.update(ms_batch_doubled=doubled["ms"], ms_ptgp=pt["ms"], plain_ms_ptgp=pt["plain_ms"],
                  bound_ms_ptgp=pt["bound_ms"])
    (pk,) = time_loop_forward("mp2018 capacity 96" + packed_label(mp_packed), mp2018, mp_packed,
                              card).values()
    timing["packed"] = {k: pk[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "measured_bound_ms", "flops")}
    print(f"scann_loop at mp2018: B=128 ({doubled['cluster']} block per structure) takes "
          f"{doubled['ms'] / timing['ms']:.2f}x the time of B=64 ({timing['cluster']} blocks per "
          f"structure) for twice the work; one block per structure at B=64 "
          f"{timing['ms_one_block'] / timing['ms']:.2f}x  [{card}]", flush=True)
    at_once = {c: kloop.max_active_forward_clusters(mp2018, 64, 96, 32, c) for c in every}
    print(f"scann_loop clusters that run at once at the MP2018 shape, by blocks per structure: "
          f"{at_once} (the wrapper's rule counts on {kloop.CLUSTERS_AT_ONCE}; fewer would cost "
          f"a second wave, not the result)", flush=True)
    print(f"phase 6: worst loop-forward abs error {worst:.3e}  [{card}]", flush=True)
    return worst, timing


def layer_inputs(rng, B, M, N, D, H, g_update, K=20):
    """Seeded inputs and parameters of one LocalAttention layer, on the card."""
    from scann_tpu_torch.kernels.local_attention import PARAM_KEYS

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    mask = (rng.uniform(size=(B, M, N)) > 0.25).astype(np.float32)
    mask[..., 0] = 1.0
    shapes = {"filter_geo/kernel": (3 * D if g_update else K, D), "key/kernel": (D, D),
              "query/kernel": (D, D)}
    params = {}
    for key in PARAM_KEYS[: 10 if g_update else 8]:
        shape = shapes.get(key, (D,))
        params[key] = f32(rng.uniform(0.5, 1.5, size=shape) if key.endswith("scale")
                          else 0.1 * rng.normal(size=shape))
    return (f32(rng.normal(size=(B, M, D))),
            torch.from_numpy(rng.integers(0, M, size=(B, M, N)).astype(np.int32)).cuda(),
            f32(rng.normal(size=(B, M, N, D if g_update else K))), f32(mask),
            f32(rng.uniform(0.3, 3.0, size=(B, M, N))), params, H, 0.5, g_update)


def layer_cast(args, dt):
    """``layer_inputs``' tensors and parameters in dtype ``dt`` (the neighbour
    indices stay int32)."""
    return (*[t if not t.is_floating_point() else t.to(dt) for t in args[:5]],
            {k: v.to(dt) for k, v in args[5].items()}, *args[6:])


def time_local_attention(args, card):
    """Kernel #5 on one layer's inputs, in turns with its plain version
    (plain, kernel, kernel, plain), against its bound: the products as three
    TF32 passes and ``layer_fp32_flops`` at the FP32 rate, or one pass over
    inputs and outputs at the HBM rate."""
    from scann_tpu_torch.kernels import local_attention as kla

    centers, idx, geometry, mask, weight, params, H, _, g_update = args
    B, M, D = centers.shape
    N = idx.shape[2]
    flops = kla.layer_flops(B, M, N, D, g_update, geometry.shape[-1])
    nbytes = (tensor_bytes([centers, idx, geometry, mask, None if g_update else weight],
                           params.values())
              + 4 * (centers.numel() + B * M * N * H + (geometry.numel() if g_update else 0)))
    bound, by, measured = bound_ms(flops, nbytes, kla.layer_fp32_flops(B, M, N, D))
    with torch.inference_mode():
        ms, plain_ms = in_turns_ms(lambda: kla.reference_local_attention(*args),
                                   lambda: kla._launch(*args), 3, 10)
        b2b = back_to_back_ms(lambda: kla._launch(*args))
    block = kla.make_plan(B, M, N, D, H, g_update, kla.sm_count(centers.device))[0]
    print(f"local_attention ({'scann+' if g_update else 'scann'}) at B={B} M={M} N={N} D={D} "
          f"(atom block {block}; timed in turns: plain, kernel, kernel, plain): kernel "
          f"{ms:.4f} ms ({b2b:.4f} ms a launch back to back), plain {plain_ms:.4f} ms, "
          f"{flops:.4e} FLOP, {nbytes} bytes, bound {bound:.4f} ms by {by} "
          f"({100 * bound / ms:.1f}% of it reached)  [{card}]", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "flops": flops,
            "measured_bound_ms": measured, "ms_back_to_back": b2b}


def phase7(mp2018, failures, card):
    """The per-layer LocalAttention kernel against its plain version at a
    ragged small layer, an M beyond the loop kernel's gate and one MP2018
    layer (SCANN+ and SCANN), each relaunched into outputs filled with NaN
    that must come back bit for bit; its time at the last two shapes (SCANN
    at the MP2018 layer only); the
    per-layer model against the eager model. Returns (largest abs error,
    timing at the MP2018 layer, SCANN+, with the other three beside it)."""
    import dataclasses

    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.models.scann import check_index_ranges, init_params, scann_forward

    rng = np.random.default_rng(7)
    worst, times = 0.0, {}
    D, H = mp2018.local_dim, mp2018.num_head
    for g_update in (True, False):
        what = "scann+" if g_update else "scann"
        # a ragged small layer, an M beyond the loop kernel's gate, one MP2018 layer
        for B, M, N, d, h in ((3, 40, 8, 32, 4), (8, 256, 32, D, H), (64, 96, 32, D, H)):
            args = layer_inputs(rng, B, M, N, d, h, g_update)
            kla.check_neighbor_range(*kla.index_bounds(args[1]), M)   # the wrapper reads nothing
            with torch.inference_mode():
                out, geo, attn = kla.fused_local_attention(*args)
                torch.cuda.synchronize()
                out0, geo0, attn0 = kla.reference_local_attention(*args)
                kept = tuple(None if t is None else torch.full_like(t, float("nan"))
                             for t in (out, geo if g_update else None, attn))
                again = kla._launch(*args, outputs=kept)
                torch.cuda.synchronize()
            named = [("out", out, out0, ATOL), ("attn", attn, attn0, ATTN_ATOL)]
            if g_update:
                named.append(("geometry", geo, geo0, ATOL))
            tag = f"phase 7 layer {what} B={B} M={M} N={N} D={d}"
            worst = max(worst, hold(tag, named, failures))
            differ = [w for w, a, b in zip(("out", "geometry", "attn"), again,
                                           (out, geo if g_update else None, attn))
                      if a is not None and not torch.equal(a, b)]
            print(f"{tag}: a relaunch into NaN-filled outputs bit-identical: {not differ}",
                  flush=True)
            if differ:
                failures.append(f"{tag}: a relaunch into NaN-filled outputs differs in {differ}")
            if M > 40 and (g_update or M == 96):   # SCANN timed at the MP2018 layer only
                times[(what, M)] = time_local_attention(args, card)
    timing = dict(times[("scann+", 96)])
    for (what, M), t in times.items():
        if (what, M) != ("scann+", 96):
            suffix = ("_scann" if what == "scann" else "") + ("_m256" if M == 256 else "")
            timing.update({f"{k}{suffix}": t[k]
                           for k in ("ms", "plain_ms", "bound_ms", "ms_back_to_back")})

    # the per-layer model (what use_attn_norm: false and oversize structures run)
    for g_update in (True, False):
        cfm = dataclasses.replace(mp2018, use_attn_norm=False, n_attention=3, g_update=g_update)
        x = synthetic_batch(rng, 8, 96, 32, n_atoms=cfm.n_atoms, min_atoms=20)
        p = init_params(cfm, torch.Generator().manual_seed(7), "cuda")
        check_index_ranges(x, cfm)
        before = kla.fused_local_attention.launches
        with torch.inference_mode():
            pred, ga = scann_forward(p, x, cfm, use_pallas=True)
            torch.cuda.synchronize()
            pred0, ga0 = scann_forward(p, x, cfm)
        n = kla.fused_local_attention.launches - before
        worst = max(worst, hold(f"phase 7 per-layer model use_attn_norm=False "
                                f"{'scann+' if g_update else 'scann'} ({n} launches)",
                                [("pred", pred, pred0, ATOL), ("ga", ga, ga0, ATOL)], failures))
        if n != cfm.n_attention:
            failures.append(f"per-layer model launched the layer kernel {n} times for "
                            f"{cfm.n_attention} layers")
    print(f"phase 7: worst per-layer abs error {worst:.3e}  [{card}]", flush=True)
    return worst, timing


def phase_rates(qm9_model, failures, card):
    """Phase 11 (run first): the card's rates by the probes of
    ``csrc/roofline_probe.cu`` (``utils.roofline.measure_device_rates``,
    measured anew), each beside its published peak; a rate over
    ``RATE_LIMIT`` x its peak means a probe is wrong and fails. Fills
    ``MEASURED``, which every later bound is also taken at, and prints the
    step ceilings of the QM9 and MP2018 training shapes."""
    from scann_tpu_torch.utils.flops import peak_tflops
    from scann_tpu_torch.utils.roofline import measure_device_rates, step_ceiling

    t0 = time.time()
    rates = measure_device_rates(use_cache=False)
    fp32, tf32, hbm, exp, bf16 = published_rates()
    rows = [("expf on the special-function units", rates["exp_per_s"], exp, "/s"),
            ("FP32 FMA on the CUDA cores (2 FLOP each)", 2 * rates["elem_per_s"], fp32, "FLOP/s"),
            ("TF32 mma.sync m16n8k8 on the tensor cores", rates["tf32_tflops"] * 1e12, tf32,
             "FLOP/s"),
            ("BF16 mma.sync m16n8k16 on the tensor cores", rates["bf16_tflops"] * 1e12, bf16,
             "FLOP/s"),
            ("HBM stream over 1 GiB (read + write)", rates["hbm_gbps"] * 1e9, hbm, "bytes/s")]
    for what, got, peak, unit in rows:
        print(f"phase 11 rate: {what}: {got:.4e} {unit}, {100 * got / peak:.1f}% of the "
              f"published {peak:.4e}", flush=True)
        if not got > 0 or got > RATE_LIMIT * peak:
            failures.append(f"phase 11: measured {what} {got:.4e} {unit} is not within "
                            f"(0, {RATE_LIMIT} x {peak:.4e}]: the probe is wrong")
    print(f"phase 11: rates measured in {time.time() - t0:.1f} s on {rates['device_kind']}, SM "
          f"clock {rates['sm_clock_mhz']} MHz under the HBM stream, power limit "
          f"{rates['power_limit_w']} W  [{card}]", flush=True)
    MEASURED.update(rates)
    mp2018 = crystal_models()[0]
    for name, cfm, M, N, B in (("QM9", qm9_model, 32, 16, 128), ("MP2018", mp2018, 96, 32, 64)):
        for training in (True, False):
            c = step_ceiling(cfm, M, N, B, rates=rates, training=training,
                             peak_tflops_override=peak_tflops(H100))
            print(f"phase 11 ceiling {name} ({M}, {N}) B={B} "
                  f"{'training' if training else 'forward'}: tensor {c['t_tensor_us']:.3f} us, "
                  f"CUDA cores {c['t_cuda_cores_us']:.3f} us, HBM {c['t_hbm_us']:.3f} us a "
                  f"structure; bound by {c['binding_engine']}: {c['structs_per_s']:.1f} "
                  f"structures/s (serial {c['structs_per_s_serial']:.1f}), MFU ceiling "
                  f"{c['mfu_ceiling']:.4f} of {peak_tflops(H100)} TFLOP/s TF32", flush=True)
    return rates


def same_neighbors(a, b):
    """Whether two structures' neighbour records agree: species and index in
    the same order, the solid angles and distance to 1e-8."""
    return len(a) == len(b) and all(
        [(r[0], r[1]) for r in x] == [(r[0], r[1]) for r in y]
        and all(abs(p - q) <= 1e-8 for r, u in zip(x, y) for p, q in zip(r[2:], u[2:]))
        for x, y in zip(a, b))


def phase_featurizers(failures, card):
    """Phase 12: the Voronoi featurizer of the dataset and serving paths
    (``data/featurize.featurize_record``) by the native path
    (``native/voronoi_cell.cc``, the default) and by the scipy/Qhull path
    (``SCANN_TPU_NATIVE_VORONOI=0``) on the same structures: the first 48
    MP2018-like crystals of phase 10's set (20-90 sites), the 6 crystals
    phase 8 serves (20-200 sites) and the first 128 QM9-like molecules of
    phase 5's set (5-29 atoms). Prints ms per structure on each path; the
    neighbour records must agree: species and index in the same order, the
    solid angles and distance to 1e-8. Returns {kind: (native ms, scipy ms)}."""
    from scann_tpu_torch.data import native, native_voronoi
    from scann_tpu_torch.data.featurize import featurize_record
    from scann_tpu_torch.data.synthetic import _random_crystal, _random_molecule

    t0 = time.time()
    native_voronoi.get_lib()
    native.get_lib()
    print(f"phase 12: built the host libraries (g++ -O3 -march=native) in "
          f"{time.time() - t0:.1f} s", flush=True)

    def crystal(sp, xyz, lat):
        return {"Atoms": sp, "Coords": xyz.astype(np.float32),
                "Lattice": lat.astype(np.float32), "Cartesian": True}

    rng = np.random.default_rng(0)                  # make_synthetic_dataset's draws
    sets = {"crystal": [], "molecule": []}
    for _ in range(48):
        sets["crystal"].append(crystal(*_random_crystal(rng, int(rng.integers(20, 91)))))
    rng = np.random.default_rng(8)                  # phase 8's crystals
    sets["served crystal"] = [crystal(*_random_crystal(rng, n))
                              for n in (20, 37, 54, 71, 90, 200)]
    rng = np.random.default_rng(0)
    for _ in range(128):
        sp, xyz = _random_molecule(rng, int(rng.integers(5, 30)))
        sets["molecule"].append({"Atoms": sp, "Coords": xyz.astype(np.float32)})

    old = os.environ.get("SCANN_TPU_NATIVE_VORONOI")
    out = {}
    try:
        for kind, recs in sets.items():
            got = {}
            for path, flag in (("native", "1"), ("scipy", "0")):
                os.environ["SCANN_TPU_NATIVE_VORONOI"] = flag
                t = time.perf_counter()
                got[path] = [featurize_record(r) for r in recs]
                got[path + " ms"] = 1e3 * (time.perf_counter() - t) / len(recs)
            bad = sum(not same_neighbors(a, b) for a, b in zip(got["native"], got["scipy"]))
            sites = [len(r["Atoms"]) for r in recs]
            print(f"phase 12 {kind}s ({len(recs)}, {min(sites)}-{max(sites)} sites): native "
                  f"{got['native ms']:.3f} ms a structure, scipy {got['scipy ms']:.3f} ms "
                  f"({got['scipy ms'] / got['native ms']:.1f}x); records differ in {bad} of "
                  f"{len(recs)}  [{card}]", flush=True)
            if bad:
                failures.append(f"phase 12: native and scipy Voronoi records differ in {bad} of "
                                f"{len(recs)} {kind}s")
            out[kind] = (got["native ms"], got["scipy ms"])
    finally:
        if old is None:
            os.environ.pop("SCANN_TPU_NATIVE_VORONOI", None)
        else:
            os.environ["SCANN_TPU_NATIVE_VORONOI"] = old
    return out


class ServingSpans:
    """Spans of one serving run (``utils.Timer``): host featurization
    (``Scann.featurize_structures``, on the featurizer thread) and pad +
    launch + read-back (``Scann.predict_featurized``, on the device thread),
    each ended by ``torch.cuda.synchronize()``; and, per device batch, when
    each began and ended, so that a request's wall time splits into queue
    wait (HTTP parse and the coalescing window), featurize, hand-off (the
    double buffer), pad/launch and the response. Batches are told apart by
    their structures' site counts."""

    def __init__(self, scann):
        from scann_tpu_torch.utils import Timer

        self.scann, self.timer, self.batches = scann, Timer(), []
        featurize, predict = scann.featurize_structures, scann.predict_featurized

        def timed_featurize(structs, **kw):
            t0 = time.perf_counter()
            with self.timer("featurize"):
                out = featurize(structs, **kw)
                torch.cuda.synchronize()
            self.batches.append({"sites": [len(s) for s in out[0]],
                                 "featurize": (t0, time.perf_counter())})
            return out

        def timed_predict(structs, all_inputs, **kw):
            t0 = time.perf_counter()
            with self.timer("pad_launch"):
                out = predict(structs, all_inputs, **kw)
                torch.cuda.synchronize()
            sites = [len(s) for s in structs]
            for b in reversed(self.batches):
                if b["sites"] == sites and "launch" not in b:
                    b["launch"] = (t0, time.perf_counter())
                    break
            return out

        scann.featurize_structures = timed_featurize
        scann.predict_featurized = timed_predict

    def close(self):
        del self.scann.featurize_structures, self.scann.predict_featurized

    def report(self, label, sent, card):
        """One line per request: ``sent`` maps name -> (site count, start,
        end) on ``time.perf_counter``'s clock."""
        for name, (n, start, end) in sent.items():
            b = next((b for b in self.batches if n in b["sites"] and "launch" in b), None)
            if b is None:
                print(f"{label} request {name}: no span (answered by the per-request "
                      "fallback)", flush=True)
                continue
            (f0, f1), (l0, l1) = b["featurize"], b["launch"]
            ms = lambda a, z: 1e3 * (z - a)
            print(f"{label} request {name} ({n} sites, batch of {len(b['sites'])}): wall "
                  f"{ms(start, end):.1f} ms = queue wait {ms(start, f0):.1f} + featurize "
                  f"{ms(f0, f1):.1f} + hand-off {ms(f1, l0):.1f} + pad/launch "
                  f"{ms(l0, l1):.1f} + response {ms(l1, end):.1f}  [{card}]", flush=True)
        print(f"{label} spans (Timer):\n  " + self.timer.summary().replace("\n", "\n  "),
              flush=True)


def cif_text(name, species, coords, lattice):
    """A P1 CIF of an orthorhombic cell with cartesian ``coords``."""
    abc = np.diag(lattice)
    rows = "".join(f"{s} {x:.6f} {y:.6f} {z:.6f}\n"
                   for s, (x, y, z) in zip(species, np.asarray(coords) / abc))
    return (f"data_{name}\n_cell_length_a {abc[0]:.6f}\n_cell_length_b {abc[1]:.6f}\n"
            f"_cell_length_c {abc[2]:.6f}\n_cell_angle_alpha 90.0\n_cell_angle_beta 90.0\n"
            "_cell_angle_gamma 90.0\nloop_\n_atom_site_type_symbol\n_atom_site_fract_x\n"
            "_atom_site_fract_y\n_atom_site_fract_z\n" + rows)


def phase8(mp2018, run_dir, failures, card):
    """The crystal serving path: PredictionServer over the MP2018 model that
    phase 10 trained, loaded from its run directory
    (``BatchedPredictor.from_model_dir``), synthetic periodic crystals posted
    as CIF and as JSON; every rung takes the loop kernel (the 200-site
    crystal's rung M = 256 its tall build), none the per-layer kernel.
    Returns the launches of (the loop kernel, the per-layer kernel) on that
    path."""
    from scann_tpu_torch.data.cif import parse_cif
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.data.synthetic import _random_crystal
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import scann_forward
    from scann_tpu_torch.serve import BatchedPredictor, PredictionServer

    counters = (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)
    for c in counters:
        c.launches = 0                               # counts of the serving path only
    kloop.launch_loop_forward.tall_launches = 0
    t_serve = time.time()
    predictor = BatchedPredictor.from_model_dir(run_dir, max_batch=64, window_ms=20.0,
                                                warmup_shapes=[])
    scann = predictor.scann
    hyper = scann.config.hyper
    routes = []                                  # (route, M, N, B) of every device batch
    forward_eval = scann.trainer.forward_eval

    def recorded_forward(params, batch):
        B, M = batch["atomic"].shape[:2]
        N = batch["neighbors"].shape[2]
        routes.append((scann.trainer.eval_route(M, N), M, N, B))
        return forward_eval(params, batch)

    scann.trainer.forward_eval = recorded_forward
    print(f"crystal serving: warmed {scann.warmup_serving([(96, 32)])} at one structure",
          flush=True)
    rng = np.random.default_rng(8)
    crystals = {f"crystal{n}": _random_crystal(rng, n) for n in (20, 37, 54, 71, 90, 200)}
    bodies, sent = {}, {}
    for i, (name, (sp, xyz, lat)) in enumerate(crystals.items()):
        if i % 2 == 0:
            sent[name] = cif_text(name, sp, xyz, lat)
            bodies[name] = (sent[name].encode(), "text/plain")
        else:
            bodies[name] = (json.dumps({"structures": [{
                "species": sp, "coords": xyz.tolist(), "lattice": lat.tolist()}]}).encode(),
                            "application/json")

    spans = ServingSpans(scann)
    server = PredictionServer(predictor, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    answers, latencies, wall = {}, {}, {}

    def post(name, body, ctype):
        t = time.perf_counter()
        req = urllib.request.Request(base + "/predict", data=body,
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[name] = (r.status, json.loads(r.read()))
        except Exception as e:  # recorded, then reported as a failure below
            answers[name] = (getattr(e, "code", None), {"error": repr(e)})
        wall[name] = (len(crystals[name][0]), t, time.perf_counter())
        latencies[name] = 1e3 * (wall[name][2] - t)

    try:
        threads = [threading.Thread(target=post, args=(n, *b)) for n, b in bodies.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        server.shutdown()
        thread.join(10)
    torch.cuda.synchronize()
    serve_s = time.time() - t_serve
    fused_n, loop_n, layer_n = (c.launches for c in counters)
    tall_n = kloop.launch_loop_forward.tall_launches
    del scann.trainer.forward_eval
    spans.close()
    spans.report("phase 8", wall, card)
    from scann_tpu_torch.api import _ladder

    for name, (sp, xyz, lat) in crystals.items():
        status, out = answers.get(name, (None, {}))
        if status != 200:
            failures.append(f"{name}: HTTP {status} {out}")
            continue
        value, ga = out["predictions"][0], np.asarray(out["ga_scores"][0])
        # the reference featurizes exactly what was sent (the CIF text is rounded)
        struct = parse_cif(sent[name]) if name in sent else Structure(sp, xyz, lat)
        _, inputs = scann.featurize_structures([struct])
        with torch.inference_mode():
            p0, g0 = scann_forward(scann.params, scann._to_device(inputs[0]), mp2018)
        ref = p0[0, 0].item() * hyper.target_std + hyper.target_mean
        ref_ga = g0[0, :len(sp), 0].cpu().numpy()
        err_v, err_g = abs(value - ref), float(np.abs(ga - ref_ga).max())
        ok = (np.isfinite(value) and np.isfinite(ga).all() and ga.shape == (len(sp),)
              and err_v <= ATOL + RTOL * abs(ref)
              and np.all(np.abs(ga - ref_ga) <= ATOL + RTOL * np.abs(ref_ga)))
        M, N = inputs[0]["neighbors"].shape[1:]
        rung = (_ladder(M, scann.config.tpu.atoms_pad_multiple),
                _ladder(N, scann.config.tpu.neighbors_pad_multiple))
        batch = [r for r in routes[1:] if r[1:3] == rung]
        print(f"{name} ({'CIF' if name in sent else 'JSON'}, {len(sp)} sites, featurized "
              f"M={M} N={N}, rung {rung}: batches of B={[r[3] for r in batch]} by the "
              f"{batch[-1][0] if batch else None} route): HTTP 200 {value:.6f} eager={ref:.6f} "
              f"|d|={err_v:.2e} "
              f"ga max|d|={err_g:.2e} latency {latencies[name]:.1f} ms", flush=True)
        if not ok:
            failures.append(f"{name}: served answer differs from the eager model "
                            f"({err_v:.3e}, {err_g:.3e})")
    taken = {r: [(M, N, B) for q, M, N, B in routes if q == r]
             for r in ("fused", "loop", "per_layer")}
    tall_want = sum(kloop.is_tall(mp2018, M, N) for M, N, _ in taken["loop"])
    print(f"crystal serving from {run_dir}: {len(answers)} requests, {len(routes)} device "
          f"batches (the warm-up's included) by route, as (M, N, B): {taken}; launches: "
          f"molecule kernel {fused_n}, loop kernel {loop_n} ({tall_n} of its tall build), "
          f"per-layer kernel {layer_n}; {serve_s:.1f} s from predictor start  [{card}]",
          flush=True)
    if sum(B for _, _, _, B in routes[1:]) != len(crystals):
        failures.append(f"served batches {routes[1:]} do not hold each of the {len(crystals)} "
                        "crystals once")
    if (loop_n == 0 or loop_n != len(taken["loop"]) or fused_n != len(taken["fused"])
            or taken["per_layer"] or layer_n != 0 or tall_n != tall_want or tall_n == 0):
        failures.append(f"launches do not match the routes taken: {taken}, molecule {fused_n}, "
                        f"loop {loop_n} ({tall_n} tall, {tall_want} wanted), per-layer "
                        f"{layer_n}")
    return loop_n, layer_n


# ---- phase 14: model.dtype bfloat16 (the bf16 operand mode, #5 on bf16) ------

BF16_RTOL, BF16_ATOL = 0.05, 0.02   # JAX's own bf16 bound (tests/test_kernels.py:236)
BF16_GAP = 0.1                      # of the plain bf16-vs-f32 mean gap
BF16_FLOOR = 2.0                    # of the f32-noise floor, where that is above the gap's share
BF16_COSINE = 0.999                 # bf16 against f32 gradients (tests/test_kernels.py:273)
JITTERS = 3                         # draws of about one f32 ulp on the weights (phase 15's floor)


def hold_bf16(label, got16, plain16, plain32, got32, failures, plain16_f64=None,
              versus_f32=True, below_f32=None, plain16_moved=()):
    """A kernel in bf16 against its bf16 plain version on the same inputs.

    The mean absolute difference over all outputs must be at most
    ``BF16_GAP`` x the plain version's own bf16-vs-f32 mean difference (the
    rounding pattern, not merely values near f32). With ``plain16_f64``, the
    bf16 plain version with f64 arithmetic between the same roundings, the
    f32-noise floor is that version's distance from the f32 one: f32 sums in
    another order alone flip bf16 roundings, and at full width they move
    the result by 0.04-0.05 x the gap for #1 with one layer, 0.18-0.30 x for
    #3 with one layer and 0.35-0.76 x at full depth. The limit is then the
    larger of the gap's share and ``BF16_FLOOR`` x the floor (with
    ``plain16_moved``, the bf16 plain version on weights moved by about one
    f32 ulp, the largest distance of the two kinds, as phase 15 and
    ``tests/test_torch_bf16_shapes.py`` take it), and with
    ``below_f32`` the kernel must also lie within that share of the f32
    kernel's own mean distance from the bf16 plain version: the reading of
    a kernel that skipped the bf16 mode, printed for every case. With
    ``versus_f32`` (the full-width shapes), every output must also lie
    within rtol/atol ``BF16_RTOL``/``BF16_ATOL`` of the same kernel in f32
    on the same inputs; random weights with one layer, or without ga_norm,
    move the outputs further in bf16, in the plain version as in the
    kernel. Returns the largest absolute difference from the bf16 plain
    version."""
    cat = lambda ts: torch.cat([t.double().reshape(-1) for t in ts])
    k16, p16, p32, k32 = cat(got16), cat(plain16), cat(plain32), cat(got32)
    gap = (k16 - p16).abs().mean().item()
    rounding = max((p16 - p32).abs().mean().item(), 1e-30)
    skipped = (k32 - p16).abs().mean().item()
    worst = (k16 - p16).abs().max().item()
    near = (bool(((k16 - k32).abs() <= BF16_ATOL + BF16_RTOL * k32.abs()).all())
            and bool(torch.isfinite(k16).all()))
    limit = BF16_GAP * rounding
    line = (f"{label}: mean |bf16 kernel - bf16 plain| {gap:.3e} = {gap / rounding:.4f} x "
            f"mean |bf16 plain - f32 plain| {rounding:.3e} (the f32 kernel at "
            f"{skipped / rounding:.4f} x)")
    if plain16_f64 is not None:
        floor = max((p16 - cat(q)).abs().mean().item() for q in (plain16_f64, *plain16_moved))
        limit = max(limit, BF16_FLOOR * floor)
        how = "f32 against f64 sums" + (" and moved weights" if plain16_moved else "")
        line += (f"; f32-noise floor (bf16 plain, {how}) {floor:.3e} = "
                 f"{floor / rounding:.4f} x, the kernel at {gap / max(floor, 1e-30):.3f} x it")
    ok = gap <= limit
    line += f"; limit {limit / rounding:.4f} x"
    if below_f32 is not None:
        ok = ok and gap <= below_f32 * skipped
        line += f" and {below_f32} x the f32 kernel's"
    print(line + f"; max {worst:.3e}; max |bf16 kernel - f32 kernel| "
          f"{(k16 - k32).abs().max().item():.3e} (rtol {BF16_RTOL}, atol {BF16_ATOL})", flush=True)
    if not ok:
        failures.append(f"{label}: mean gap {gap:.3e} to the bf16 plain version over its limit")
    if versus_f32 and not near:
        failures.append(f"{label}: outside rtol {BF16_RTOL} atol {BF16_ATOL} of the f32 kernel")
    return worst


def f64_params(params):
    return {k: v.double() for k, v in params.items()}


def bf16_row(name, kernel, source, replaces, launches, worst, t, plain_ms, flops, fp32_flops,
             nbytes, card, bf16_products=True):
    """One row of the {"kernels": ...} line for a kernel in bf16, with its
    f32 time from the same run. With ``bf16_products`` (#1 and #3 in the
    bf16 operand mode) its bound counts the products once at the dense BF16
    rate; #5 on bf16 tensors keeps f32 products (its in-kernel LayerNorm
    and geometry feed f32 operands), so only its bytes are bf16 sizes."""
    bound, by, measured = bound_ms(flops, nbytes, fp32_flops, bf16=bf16_products)
    ms, f32_ms = t
    print(f"{name} ({kernel} in bf16): {ms:.4f} ms beside {f32_ms:.4f} ms in f32 (timed in "
          f"turns), plain {plain_ms:.4f} ms, {flops:.4e} FLOP, {nbytes} bytes, bound "
          f"{bound:.4f} ms by {by} ({100 * bound / ms:.1f}% of it reached)  [{card}]", flush=True)
    return {"name": name, "kernel": kernel, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": worst, "ms": ms,
            "f32_ms": f32_ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "measured_bound_ms": measured, "library_ms": None, "flops": flops}


def bf16_serve(label, scann, structs, failures):
    """One request of ``structs`` through ``PredictionServer`` on ``scann``
    -> (routes of its device batches, the answers (value, ga) or None)."""
    from scann_tpu_torch.serve import BatchedPredictor, PredictionServer

    routes = []
    forward_eval = scann.trainer.forward_eval

    def recorded_forward(params, batch):
        routes.append(scann.trainer.eval_route(batch["atomic"].shape[1],
                                               batch["neighbors"].shape[2]))
        return forward_eval(params, batch)

    scann.trainer.forward_eval = recorded_forward
    predictor = BatchedPredictor(scann, max_batch=64, window_ms=5.0, warmup_shapes=[])
    server = PredictionServer(predictor, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    body = json.dumps({"structures": [
        {"species": list(s.species), "coords": np.asarray(s.coords).tolist(),
         "lattice": None if s.lattice is None else np.asarray(s.lattice).tolist()}
        for s in structs]}).encode()
    t = time.perf_counter()
    try:
        req = urllib.request.Request(f"http://{server.host}:{server.port}/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            status, out = r.status, json.loads(r.read())
    except Exception as e:  # recorded, then reported as a failure below
        status, out = getattr(e, "code", None), {"error": repr(e)}
    finally:
        server.shutdown()
        thread.join(10)
        predictor.close()
    torch.cuda.synchronize()
    del scann.trainer.forward_eval
    print(f"{label}: one request of {len(structs)} structures: HTTP {status}, device batches "
          f"by route {routes}, {1e3 * (time.perf_counter() - t):.1f} ms", flush=True)
    if status != 200:
        failures.append(f"{label}: HTTP {status} {out}")
        return routes, None
    return routes, list(zip(out["predictions"], out["ga_scores"]))


def check_served(label, scann, structs, answers, failures):
    """Every served answer equal, bit for bit, to ``Scann.predict_structure``
    of the same structure in this process."""
    for s, (value, ga) in zip(structs, answers or []):
        ref, ref_ga = scann.predict_structure(s)
        ga = np.asarray(ga)
        same = value == ref and np.array_equal(ga, ref_ga)
        print(f"{label}: {len(s)} sites: served {value:.6f}, predict_structure {ref:.6f}, "
              f"equal: {same}", flush=True)
        if not (same and np.isfinite(value) and np.isfinite(ga).all()):
            failures.append(f"{label}: the served answer for {len(s)} sites differs from "
                            "Scann.predict_structure")


def phase14(matrix, qm9_model, mp2018, qm9_inputs, packed_qm9, mp_packed, failures, card):
    """model.dtype bfloat16. Kernels #1 and #3 in the bf16 operand mode and
    #5 on bfloat16 tensors against their bf16 plain versions
    (``hold_bf16``): #1 and #3 on the small matrix (unpacked and packed) at
    0.1 x the plain bf16-vs-f32 gap; at full width (#1 at QM9 and packed at
    capacity 48, #3 at MP2018 and packed at capacity 96, each relaunched on
    NaN- and constant-filled scratch, bit for bit) within 2 x the f32-noise
    floor and 0.9 x the f32 kernel's distance, and at the same widths and
    inputs with one layer within the larger of 0.1 x the gap and 2 x the
    floor and 0.5 x the f32 kernel's distance; #5 at one MP2018 layer and
    at (8, 256, 32) at 0.1 x the gap
    (relaunched into NaN-filled outputs); their times in turns with the f32
    kernels'. Then the main path: one served request of a bf16 QM9 model
    and one of a bf16 MP2018 model (a 90-site crystal by #3's narrow build,
    a 260-site one at the rung M = 384 by its tall build) through
    ``PredictionServer``, then one request of the 90-site crystal to an
    MP2018 model with ``use_attn_norm: false`` (which no whole-model kernel
    takes: the per-layer route, #5 on every layer), in bf16 (#5's bf16
    entry) and in f32 (its f32 entry), with the launch counts set to 0
    before and read after. Returns the three rows of the {"kernels": ...}
    line and the launches of #3's tall build in bf16 (``3-tall-bf16``)."""
    import dataclasses

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.data.synthetic import _random_crystal
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    t0 = time.time()
    bf16 = lambda cfm: dataclasses.replace(cfm, dtype="bfloat16")
    worst, times, plain_ms, work = {1: 0.0, 3: 0.0, 5: 0.0}, {}, {}, {}

    # ---- #1 and #3 on the small matrix, unpacked and packed: the 0.1 x gap -------
    rng = np.random.default_rng(14)
    for name, cfm, mrelu in matrix:
        p = init_params(cfm, torch.Generator().manual_seed(14), "cuda")
        packed = kfwd.pack_params(p, cfm)
        ring, cgcnn = cfm.use_ring, cfm.feature == "cgcnn"
        for shape, x in (("", synthetic_batch(rng, 64, 16, 8, ring, cgcnn)),
                         (" packed", pack_batch(synthetic_batch(rng, 96, 8, 8, ring, cgcnn), 16))):
            for n, launch, plain in ((1, kfwd._launch, kfwd.reference_scann_forward),
                                     (3, kloop._launch, kloop.reference_loop_forward)):
                with torch.inference_mode():
                    kfwd._check_inputs(x, cfm, packed["wde"].device)
                    got = (launch(packed, x, bf16(cfm), mrelu), plain(p, x, bf16(cfm), mrelu),
                           plain(p, x, cfm, mrelu), launch(packed, x, cfm, mrelu))
                worst[n] = max(worst[n], hold_bf16(
                    f"phase 14 #{n} bf16 {name}{shape}{packed_label(x)}", *got, failures,
                    versus_f32=False))

    # ---- #1 at full width: QM9 and packed at capacity 48 ---------------------------
    qm9_16 = bf16(qm9_model)
    params = init_params(qm9_model, torch.Generator().manual_seed(14), "cuda")
    packed = kfwd.pack_params(params, qm9_model)
    for label, x in (("qm9", qm9_inputs), ("qm9 capacity 48", packed_qm9[48])):
        with torch.inference_mode():
            kfwd._check_inputs(x, qm9_model, packed["wde"].device)
            got = (kfwd._launch(packed, x, qm9_16, False),
                   kfwd.reference_bf16_forward(params, x, qm9_16, exact_pools=True),
                   kfwd.reference_scann_forward(params, x, qm9_model),
                   kfwd._launch(packed, x, qm9_model, False))
            f64 = kfwd.reference_bf16_forward(f64_params(params), x, qm9_16, exact_pools=True)
        worst[1] = max(worst[1], hold_bf16(f"phase 14 #1 bf16 {label}{packed_label(x)}", *got,
                                           failures, f64, below_f32=0.9))
    x = qm9_inputs
    B, M = x["atomic"].shape
    N = x["neighbors"].shape[2]
    with torch.inference_mode():
        times[1] = in_turns_ms(lambda: kfwd._launch(packed, x, qm9_model, False),
                               lambda: kfwd._launch(packed, x, qm9_16, False), 5, 10)
        plain_ms[1] = cuda_ms(lambda: kfwd.reference_bf16_forward(params, x, qm9_16), 5)
    work[1] = (kfwd.forward_flops(qm9_model, B, M, N), kfwd.forward_fp32_flops(qm9_model, B, M, N),
               tensor_bytes(x.values(), weights(packed)) + 4 * (B + B * M))

    # ---- #3 at full width: MP2018 and packed at capacity 96, relaunched ------------
    mp_16 = bf16(mp2018)
    params = init_params(mp2018, torch.Generator().manual_seed(14), "cuda")
    packed = kfwd.pack_params(params, mp2018)
    mp_x = synthetic_batch(np.random.default_rng(14), 64, 96, 32, n_atoms=mp2018.n_atoms,
                           min_atoms=20)
    for label, x in (("mp2018", mp_x), ("mp2018 capacity 96", mp_packed)):
        B, M = x["atom_mask"].shape[:2]
        N = x["neighbors"].shape[2]
        with torch.inference_mode():
            kfwd._check_inputs(x, mp2018, packed["wde"].device)
            got = (kloop._launch(packed, x, mp_16, False), kloop.reference_loop_forward(params, x, mp_16),
                   kloop.reference_loop_forward(params, x, mp2018), kloop._launch(packed, x, mp2018, False))
            f64 = kfwd.reference_bf16_forward(f64_params(params), x, mp_16, exact_pools=False)
            scratch = kloop.loop_forward_scratch(mp2018, B, M, N, "cuda")
            differ = set()
            for i in range(2):
                for t in scratch.values():
                    if t is not None:
                        t.fill_(float("nan") if i % 2 == 0 else -3.0)
                again = kloop._launch(packed, x, mp_16, False, scratch=scratch)
                differ |= {w for w, a, b in zip(("pred", "ga"), again, got[0])
                           if not torch.equal(a, b)}
        tag = f"phase 14 #3 bf16 {label} B={B} M={M} N={N}{packed_label(x)}"
        worst[3] = max(worst[3], hold_bf16(tag, *got, failures, f64,
                                           below_f32=0.9))
        del f64
        print(f"{tag}: 2 launches on NaN- and constant-filled scratch bit-identical: "
              f"{not differ}", flush=True)
        if differ:
            failures.append(f"{tag}: bf16 launches on the same inputs differ in {sorted(differ)}")
    x = mp_x
    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    scratch = kloop.loop_forward_scratch(mp2018, B, M, N, "cuda")
    with torch.inference_mode():
        times[3] = in_turns_ms(lambda: kloop._launch(packed, x, mp2018, False, scratch=scratch),
                               lambda: kloop._launch(packed, x, mp_16, False, scratch=scratch),
                               3, 10)
        plain_ms[3] = cuda_ms(lambda: kloop.reference_loop_forward(params, x, mp_16), 3)
    work[3] = (kloop.loop_forward_flops(mp2018, B, M, N),
               kfwd.forward_fp32_flops(mp2018, B, M, N),
               tensor_bytes(x.values(), weights(packed)) + 4 * (B + B * M)
               + kloop.loop_forward_bytes(mp2018, B, M, N))
    del scratch

    # ---- #1 and #3 at the same widths, inputs, tiles and clusters, one layer ---------
    # One layer keeps the f32-noise floor low: #1 at 0.1 x the gap, #3 within
    # 2 x its floor and half the f32 kernel's distance (no rtol/atol hold:
    # one random layer moves the plain version as far in bf16).
    for n, cfm, cases, launch, plain, exact in (
            (1, qm9_model, (("qm9", qm9_inputs), ("qm9 capacity 48", packed_qm9[48])),
             kfwd._launch, kfwd.reference_scann_forward, True),
            (3, mp2018, (("mp2018", mp_x), ("mp2018 capacity 96", mp_packed)),
             kloop._launch, kloop.reference_loop_forward, False)):
        one = dataclasses.replace(cfm, n_attention=1)
        params = init_params(one, torch.Generator().manual_seed(14), "cuda")
        packed = kfwd.pack_params(params, one)
        for label, x in cases:
            with torch.inference_mode():
                kfwd._check_inputs(x, one, packed["wde"].device)
                got = (launch(packed, x, bf16(one), False), plain(params, x, bf16(one)),
                       plain(params, x, one), launch(packed, x, one, False))
                f64 = kfwd.reference_bf16_forward(f64_params(params), x, bf16(one),
                                                  exact_pools=exact)
            worst[n] = max(worst[n], hold_bf16(f"phase 14 #{n} bf16 {label} L=1{packed_label(x)}",
                                               *got, failures, f64, versus_f32=False,
                                               below_f32=0.5))

    # ---- #5 on bfloat16 tensors: one MP2018 layer and (8, 256, 32) ---------------
    rng = np.random.default_rng(15)
    D, H = mp2018.local_dim, mp2018.num_head
    for B, M, N in ((64, 96, 32), (8, 256, 32)):
        args = layer_inputs(rng, B, M, N, D, H, True)
        args16 = layer_cast(args, torch.bfloat16)
        args32 = layer_cast(args16, torch.float32)    # the same values in f32
        kla.check_neighbor_range(*kla.index_bounds(args[1]), M)
        with torch.inference_mode():
            k16 = kla._launch(*args16)
            k32 = kla._launch(*args32)
            p16 = kla.reference_layer_kernel(*args16)
            p32 = kla.reference_local_attention(*args32)
            again = kla._launch(*args16, outputs=tuple(torch.full_like(t, float("nan"))
                                                        for t in k16))
            torch.cuda.synchronize()
        tag = f"phase 14 #5 bf16 B={B} M={M} N={N} D={D}"
        order = lambda o: (o[0], o[2], o[1])           # out, attn, geometry
        worst[5] = max(worst[5], hold_bf16(tag, order(k16), order(p16), order(p32), order(k32),
                                           failures))
        if not all(torch.equal(a, b) for a, b in zip(again, k16)):
            failures.append(f"{tag}: a relaunch into NaN-filled outputs differs")
        if M == 96:
            with torch.inference_mode():
                times[5] = in_turns_ms(lambda: kla._launch(*args32), lambda: kla._launch(*args16),
                                       3, 10)
                plain_ms[5] = cuda_ms(lambda: kla.reference_layer_kernel(*args16), 3)
            nbytes = (tensor_bytes(args16[:4], args16[5].values())
                      + 2 * (args16[0].numel() + B * M * N * H + args16[2].numel()))
            work[5] = (kla.layer_flops(B, M, N, D, True), kla.layer_fp32_flops(B, M, N, D), nbytes)

    # ---- the main path: bf16 models served through PredictionServer --------------
    qm9 = Scann(ScannConfig(model=qm9_16, hyper=HyperConfig(batch_size=128, target="homo",
                                                            target_mean=-0.24, target_std=0.022),
                            tpu=TpuConfig(max_buckets=2)), device="cuda")
    qm9.init_params(seed=14)
    mp = Scann(ScannConfig(model=mp_16, hyper=HyperConfig(
        batch_size=64, target="formation_energy_per_atom", target_mean=-1.5, target_std=1.0)),
        device="cuda")
    mp.init_params(seed=14)
    mols = [Structure(*MOLECULES["benzene"])]
    # 90 sites: the loop route; 260 (rung M=384): the per-layer route
    # 90 sites: #3's narrow build; 260 (rung M=384): its tall build
    crystals = [Structure(*_random_crystal(np.random.default_rng(14), n)) for n in (90, 260)]
    counters = (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)
    for c in counters:
        c.bf16_launches = c.launches = 0
    kloop.launch_loop_forward.tall_launches = 0
    _, qm9_answers = bf16_serve("phase 14 bf16 QM9 model", qm9, mols, failures)
    routes, mp_answers = bf16_serve("phase 14 bf16 MP2018 model", mp, crystals, failures)
    tall16 = kloop.launch_loop_forward.tall_launches
    # use_attn_norm: false, which no whole-model kernel takes: #5 on every layer,
    # its bf16 entry in the bf16 model (no f32 LayerNorm between the layers), its
    # f32 entry in the f32 one
    layer_models, layer_routes, layer_answers = {}, [], {}
    for dtype in ("bfloat16", "float32"):
        model = Scann(ScannConfig(model=dataclasses.replace(mp2018, dtype=dtype,
                                                            use_attn_norm=False),
                                  hyper=mp.config.hyper), device="cuda")
        model.init_params(seed=14)
        before = kla.fused_local_attention.launches
        got, layer_answers[dtype] = bf16_serve(f"phase 14 {dtype} MP2018 model, "
                                               "use_attn_norm false", model, crystals[:1],
                                               failures)
        layer_routes += got
        layer_models[dtype] = (model, kla.fused_local_attention.launches - before)
    launches = {1: kfwd.fused_scann_forward.bf16_launches,
                3: kloop.launch_loop_forward.bf16_launches - tall16,
                5: kla.fused_local_attention.bf16_launches}
    f32_entry = layer_models["float32"][1]
    print(f"phase 14 main path: bf16 launches #1 {launches[1]}, #3 {launches[3]} narrow and "
          f"{tall16} tall, #5 {launches[5]}; #5 launches of the f32 model {f32_entry}",
          flush=True)
    if (min(launches.values()) == 0 or routes != ["loop", "loop"] or tall16 != 1
            or layer_routes != ["per_layer", "per_layer"]
            or not launches[5] == layer_models["bfloat16"][1] == mp_16.n_attention
            or f32_entry != mp2018.n_attention):
        failures.append(f"phase 14: launches {launches} (tall {tall16}, #5 of the f32 model "
                        f"{f32_entry}) do not match the routes {routes} and {layer_routes}")
    check_served("phase 14 bf16 QM9 model", qm9, mols, qm9_answers, failures)
    check_served("phase 14 bf16 MP2018 model", mp, crystals, mp_answers, failures)
    for dtype, (model, _) in layer_models.items():
        check_served(f"phase 14 {dtype} MP2018 model, use_attn_norm false", model,
                     crystals[:1], layer_answers[dtype], failures)
    print(f"phase 14: {time.time() - t0:.1f} s  [{card}]", flush=True)
    rows = [bf16_row(f"{n}-bf16", kernel, mod.SOURCE, mod.REPLACES, launches[n], worst[n],
                     times[n], plain_ms[n], *work[n], card, bf16_products=n != 5)
            for n, kernel, mod in ((1, "scann_forward", kfwd), (3, "scann_loop", kloop),
                                   (5, "local_attention", kla))]
    # the f32 model's per-layer request: #5's f32 entry, on this main path
    rows[-1]["f32_entry_launches"] = f32_entry
    return rows, {"scann_loop_tall_bf16": tall16}


# ---- phase 15: model.dtype bfloat16 training (#2 and #4 in the bf16 operand mode) ----

def chunked_train_grads(fn, params, x, y, cfm, mrelu, rate, seed, chunk):
    """A plain training-gradient function (``fn``: ``kbwd.reference_fused_scann_
    train_grads`` or ``kloop.reference_loop_train_grads``) over the batch in
    chunks of ``chunk`` rows (each chunk's masks keyed on its global rows),
    gradients summed from the first chunk on, preds concatenated: the
    autograd of a full MP2018 batch does not fit the card in f64."""
    B = x["atomic"].shape[0]
    preds, total = [], None
    for i in range(0, B, chunk):
        pred, g = fn(params, {k: v[i:i + chunk] for k, v in x.items()}, y[i:i + chunk], cfm,
                     mrelu, rate, seed, i)
        preds.append(pred.detach())
        total = g if total is None else {k: total[k] + g[k] for k in total}
    return torch.cat(preds), total


def backward_launch(n, packed, x, y, cfm, rate, seed, scratch=None, cluster=None, mrelu=False,
                    stash="auto"):
    """(pred [B, S], gradients) of one one-shot launch of #2 (``n`` 2) or #4
    in ``cfm``'s mode, with the activation stash ``stash`` (the mode rule's
    by default; None: the recompute schedule)."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    if n == 2:
        flat, pred = kbwd._launch(packed, x, cfm, y, None, True, mrelu, rate, seed, 0, stash)
    else:
        flat, pred = kloop._launch_backward(packed, x, cfm, y, None, True, mrelu, rate, seed, 0,
                                            scratch, cluster, stash)
    return pred.view(x["atomic"].shape[0], -1), kbwd.grads_from_flat(flat, packed, cfm)


def jittered(params, seed):
    """``params`` each times 1 + 1e-7 x a seeded normal draw: a change of
    about one f32 ulp, the size of the f32 sum-order differences between two
    implementations."""
    g = torch.Generator(device=next(iter(params.values())).device).manual_seed(seed)
    return {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=g, device=v.device))
            for k, v in params.items()}


def hold_bf16_grads(label, got16, plain16, plain32, floors, got32, failures, below_f32,
                    below_pred=None):
    """A backward kernel in bf16 against its bf16 plain version on the same
    inputs, each a (pred, gradients) pair. For the gradients flattened into
    one vector and for pred it prints (a) the bf16 kernel's mean distance
    from the bf16 plain version, (b) the plain version's own bf16-vs-f32 mean
    gap, (c) the f32-noise floor, the largest of the plain version's
    distances from itself with f64 arithmetic between the same roundings and
    from itself on weights moved by about one f32 ulp, in ``JITTERS`` draws
    (``floors``: (pred, gradients) pairs, the f64 one first: one draw
    understates how far f32 noise moves a bf16 result, which scatters from
    draw to draw), and (d) the f32 kernel's mean distance from the bf16
    plain version, the reading of a kernel that skipped the mode. It holds
    (a) to the larger of ``BF16_GAP`` x (b) and ``BF16_FLOOR`` x (c), and to
    ``below_f32`` x (d) (pred to ``below_pred`` x (d) where given; None: no
    such limit, where the f32-noise floor of a few structures at full depth
    reaches the whole gap); and the
    bf16 kernel's gradient cosine with the f32
    kernel's above ``BF16_COSINE``, or where the plain version's own bf16
    gradient reads below that against its f32 one, no more than 1e-4 below
    that reading. On a failure it prints the gradients that move (a) most.
    Returns the largest absolute gradient difference from the bf16 plain
    version."""
    flat = lambda g: torch.cat([g[k].double().reshape(-1) for k in sorted(g)])
    dist = lambda u, v: (u - v).abs().mean().item()
    line = [label]
    for what, sel, below in (("grads", lambda o: flat(o[1]), below_f32),
                             ("pred", lambda o: o[0].double().reshape(-1),
                              below_f32 if below_pred is None else below_pred)):
        k16, p16, p32, k32 = (sel(o) for o in (got16, plain16, plain32, got32))
        a, b, d = dist(k16, p16), max(dist(p16, p32), 1e-30), dist(k32, p16)
        c64, *cjit = (dist(p16, sel(f)) for f in floors)
        c = max(c64, *cjit)
        limit = max(BF16_GAP * b, BF16_FLOOR * c)
        if below is not None:
            limit = min(limit, below * d)
        ok = a <= limit and bool(torch.isfinite(k16).all())
        line.append(f"{what}: (a) {a:.3e} = {a / b:.4f} x (b) {b:.3e}, (c) {c / b:.4f} x (f64 "
                    f"{c64 / b:.4f}, jitter {'/'.join(f'{j / b:.4f}' for j in cjit)}), (d) "
                    f"{d / b:.4f} x; limit {limit / b:.4f} x")
        if not ok:
            failures.append(f"{label} {what}: (a) {a:.3e} over min(max({BF16_GAP} (b), "
                            f"{BF16_FLOOR} (c)), {below} (d)) = {limit:.3e}")
            if what == "grads":
                share = sorted(((got16[1][k] - plain16[1][k]).abs().sum().item(), k)
                               for k in plain16[1])[::-1][:4]
                line.append("largest shares of (a): " + ", ".join(
                    f"{k} {v / max(k16.numel() * a, 1e-30):.3f}" for v, k in share))
    cos = lambda u, v: (u @ v / (u.norm() * v.norm())).item()
    mine, own = cos(flat(got16[1]), flat(got32[1])), cos(flat(plain16[1]), flat(plain32[1]))
    line.append(f"gradient cosine with the f32 kernel's {mine:.6f} (the plain versions' "
                f"{own:.6f})")
    if not mine > min(BF16_COSINE, own - 1e-4):
        failures.append(f"{label}: gradient cosine {mine:.6f} with the f32 kernel's (the plain "
                        f"versions' {own:.6f})")
    print("  ".join(line), flush=True)
    return max((got16[1][k] - plain16[1][k]).abs().max().item() for k in plain16[1])


def phase15_matrix(matrix, failures):
    """#2 and #4 in bf16 on the small matrix of configurations (SCANN+,
    SCANN, ring features with mrelu, cgcnn, ga_norm off; 64 molecules of up to
    16 atoms, and 96 of up to 8 packed into slots of 16 rows) at dropout 0.1
    against their bf16 plain versions (``hold_bf16_grads``: within the
    larger of 0.1 x the gap and 2 x the f32-noise floor, and 0.5 x the f32
    kernel's reading). Returns the largest gradient errors."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    worst = {2: 0.0, 4: 0.0}
    rng = np.random.default_rng(150)
    for name, cfm, mrelu in matrix:
        cfm16 = dataclasses.replace(cfm, dtype="bfloat16")
        p = init_params(cfm, torch.Generator().manual_seed(15), "cuda")
        packed = kfwd.pack_params(p, cfm)
        ring, cgcnn = cfm.use_ring, cfm.feature == "cgcnn"
        for x in (synthetic_batch(rng, 64, 16, 8, ring, cgcnn),
                  pack_batch(synthetic_batch(rng, 96, 8, 8, ring, cgcnn), 16)):
            kfwd._check_inputs(x, cfm, packed["wde"].device)
            B = x["atomic"].shape[0]
            y = torch.from_numpy(rng.normal(size=(B, max(kfwd.segment_count(x), 1)))
                                 .astype(np.float32)).cuda()
            for n, plain in ((2, kbwd.reference_fused_scann_train_grads),
                             (4, kloop.reference_loop_train_grads)):
                run = lambda q, c: plain(q, x, y, c, mrelu, 0.1, 15)
                got = [backward_launch(n, packed, x, y, c, 0.1, 15, mrelu=mrelu)
                       for c in (cfm16, cfm)]
                torch.cuda.synchronize()
                floors = [run(f64_params(p), cfm16)] + [run(jittered(p, j), cfm16)
                                                        for j in range(JITTERS)]
                worst[n] = max(worst[n], hold_bf16_grads(
                    f"phase 15 #{n} bf16 {name}{packed_label(x)} dropout 0.1", got[0],
                    run(p, cfm16), run(p, cfm), floors, got[1], failures, 0.5))
    return worst


def phase15_holds(qm9_model, mp2018, qm9_inputs, packed_qm9, failures):
    """#2 and #4 in the bf16 operand mode against their bf16 plain versions
    (``hold_bf16_grads``): #2 at QM9 and packed at capacity 32, #4 at MP2018
    (B=64, 2 blocks a structure) and packed at QM9 capacity 48, each at
    dropout 0 and 0.1 at full depth (within 0.9 x the f32 kernel's reading)
    and at dropout 0.1 with one layer at the same widths, inputs, clusters
    and packing (0.5 x); both kernels relaunched, #4 on NaN- and constant-filled
    scratch at 1, 2 and 4 blocks a structure, bit for bit. Returns (the
    largest gradient errors, the MP2018 batch)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    bf16 = lambda cfm: dataclasses.replace(cfm, dtype="bfloat16")
    mp_x = synthetic_batch(np.random.default_rng(15), 64, 96, 32, n_atoms=mp2018.n_atoms,
                           min_atoms=20)
    cases = ((2, qm9_model, "qm9", qm9_inputs, kbwd.reference_fused_scann_train_grads, 64),
             (2, qm9_model, "qm9 capacity 32", packed_qm9[32], kbwd.reference_fused_scann_train_grads,
              64),
             (4, mp2018, "mp2018", mp_x, kloop.reference_loop_train_grads, 16),
             (4, qm9_model, "qm9 capacity 48", packed_qm9[48], kloop.reference_loop_train_grads, 64))
    worst = {2: 0.0, 4: 0.0}
    rng = np.random.default_rng(15)
    for depth, below in (("", 0.9), (" L=1", 0.5)):
        for n, base, label, x, plain, chunk in cases:
            cfm = base if not depth else dataclasses.replace(base, n_attention=1)
            params = init_params(cfm, torch.Generator().manual_seed(15), "cuda")
            packed = kfwd.pack_params(params, cfm)
            kfwd._check_inputs(x, cfm, packed["wde"].device)
            B = x["atomic"].shape[0]
            S = max(kfwd.segment_count(x), 1)
            y = torch.from_numpy(rng.normal(size=(B, S)).astype(np.float32)).cuda()
            for rate in (0.0, 0.1) if not depth else (0.1,):
                got16 = backward_launch(n, packed, x, y, bf16(cfm), rate, 15)
                got32 = backward_launch(n, packed, x, y, cfm, rate, 15)
                torch.cuda.synchronize()
                run = lambda p, c: chunked_train_grads(plain, p, x, y, c, False, rate, 15, chunk)
                plain16, plain32 = run(params, bf16(cfm)), run(params, cfm)
                floors = [run(f64_params(params), bf16(cfm))] + [
                    run(jittered(params, j), bf16(cfm)) for j in range(JITTERS)]
                tag = (f"phase 15 #{n} bf16 {label}{depth} B={B} M={x['atomic'].shape[1]} "
                       f"N={x['neighbors'].shape[2]}{packed_label(x)} dropout {rate}")
                worst[n] = max(worst[n], hold_bf16_grads(tag, got16, plain16, plain32, floors,
                                                         got32, failures, below))
                del plain16, plain32, floors
                if depth or rate == 0.0:
                    continue
                # the same launch again: bit for bit (#4 on kept scratch at every cluster size)
                differ = set()
                if n == 2:
                    again = backward_launch(n, packed, x, y, bf16(cfm), rate, 15)
                    differ |= {k for k in got16[1] if not torch.equal(got16[1][k], again[1][k])}
                    what = "1 bf16 relaunch"
                else:
                    M, N = x["atomic"].shape[1], x["neighbors"].shape[2]
                    for C in (1, 2, 4):
                        scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, C)
                        first = backward_launch(n, packed, x, y, bf16(cfm), rate, 15, scratch, C)
                        first = (first[0].clone(), {k: v.clone() for k, v in first[1].items()})
                        for fill in (float("nan"), -3.0):
                            for t in scratch.values():
                                if t is not None:
                                    t.fill_(fill)
                            again = backward_launch(n, packed, x, y, bf16(cfm), rate, 15, scratch, C)
                            differ |= {f"{k} at C={C}" for k in first[1]
                                       if not torch.equal(first[1][k], again[1][k])}
                            if not torch.equal(first[0], again[0]):
                                differ.add(f"pred at C={C}")
                        del scratch
                    what = ("2 bf16 relaunches on NaN- and constant-filled scratch at 1, 2 and 4 "
                            "blocks a structure each")
                print(f"{tag}: {what} bit-identical: {not differ}", flush=True)
                if differ:
                    failures.append(f"{tag}: bf16 relaunches differ in {sorted(differ)}")
            del packed, params
    return worst, mp_x


def phase15_times(qm9_model, mp2018, qm9_inputs, mp_x, card):
    """The bf16 and f32 ms of #2 at QM9 and #4 at MP2018, in turns in this
    run (f32, bf16, bf16, f32), the bf16 plain version's ms, the work
    (FLOP, of them on the CUDA cores, bytes) and the bounds."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    out = {}
    for n, cfm, x, plain, chunk in ((2, qm9_model, qm9_inputs, kbwd.reference_fused_scann_train_grads,
                                     128),
                                    (4, mp2018, mp_x, kloop.reference_loop_train_grads, 32)):
        cfm16 = dataclasses.replace(cfm, dtype="bfloat16")
        params = init_params(cfm, torch.Generator().manual_seed(16), "cuda")
        packed = kfwd.pack_params(params, cfm)
        B, M = x["atomic"].shape[:2]
        N = x["neighbors"].shape[2]
        y = torch.from_numpy(np.random.default_rng(16).normal(size=(B, 1)).astype(np.float32)).cuda()
        scratch = (kloop.loop_backward_scratch(packed, cfm, B, M, N) if n == 4 else None)
        t = in_turns_ms(lambda: backward_launch(n, packed, x, y, cfm, 0.1, 7, scratch),
                        lambda: backward_launch(n, packed, x, y, cfm16, 0.1, 7, scratch), 5, 10)
        plain_ms = statistics.median(cuda_times(lambda: chunked_train_grads(
            plain, params, x, y, cfm16, False, 0.1, 7, chunk), 2, warmup=1))
        _, P = kbwd.grad_layout(packed)
        nbytes = tensor_bytes(x.values(), weights(packed)) + 4 * B + 4 * (P + B)
        out[n] = (t, plain_ms, kbwd.backward_flops(cfm, B, M, N),
                  kbwd.backward_fp32_flops(cfm, B, M, N), nbytes)
        print(f"phase 15 #{n} at B={B} M={M} N={N} (dropout 0.1, one-shot; timed in turns: f32, "
              f"bf16, bf16, f32): bf16 {t[0]:.4f} ms, f32 {t[1]:.4f} ms, bf16 plain "
              f"{plain_ms:.4f} ms  [{card}]", flush=True)
        del scratch, packed, params
    return out


def phase15_train(qm9_model, mp2018, qm9_run, crystal_run, failures, card):
    """The main path: a bf16 QM9 model trains 2 epochs through
    ``Scann.prepare_dataset -> train -> evaluate`` on phase 5's molecules in
    one bucket (32, 16) (the "fused" route, #2 in bf16; eval by #1 in bf16),
    one step of it resumed from ``checkpoints/last`` must equal the same
    step of the trainer bit for bit; a bf16 MP2018 model trains 2 epochs on
    phase 10's crystals in one bucket (96, 32) (the "loop" route, #4 in
    bf16) and 2 in one bucket with the neighbour axis padded to 64 (the
    "loop" route on #4's wide build in bf16).
    One bucket a run, as phases 5 and 10 hold their falling losses: a pass
    over one of several buckets rides on the others' steps. Each run's epoch
    loss and training-set loss without dropout must be finite and fall, and
    the bf16 launches of #2 and #4, set to 0 just before, must equal the
    steps that took their routes, and #4's wide launches the steps of a wide
    bucket. Returns those launches (#4's narrow build, and its wide build
    under ``"scann_loop_backward_wide_bf16"``)."""
    import dataclasses

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    bf16 = lambda cfm: dataclasses.replace(cfm, dtype="bfloat16")
    counters = {2: kbwd.launch_scann_backward, 4: kloop.launch_loop_backward}
    launches = {2: 0, 4: 0, "scann_loop_backward_wide_bf16": 0}

    def train(label, cfm, info, target, bs, multiple, want):
        energy, nbr = info["data"]
        cfg = ScannConfig(model=bf16(cfm),
                          hyper=HyperConfig(batch_size=bs, scheduler="sgdr", lr=5e-4, min_lr=1e-4,
                                            target=target, data_energy_path=energy,
                                            data_nei_path=nbr, epochs=2, seed=0,
                                            save_path=os.path.join(info["work"],
                                                                   label.replace(" ", "_"))),
                          tpu=TpuConfig(max_buckets=1, neighbors_pad_multiple=multiple))
        scann = Scann(cfg, device="cuda")
        scann.prepare_dataset()
        trainer = scann.trainer
        buckets = scann.train_buckets
        routes = [trainer.train_route(*b.shape) for b in buckets]
        scann.init_params(cfg.hyper.seed)              # what fit() would draw
        sizes = np.array([b.num_structures for b in buckets], np.float64)
        set_loss = lambda: float(np.dot(bucket_losses(trainer, buckets), sizes) / sizes.sum())
        before = set_loss()
        steps = {r: 2 * sum(-(-b.num_structures // bs) for b, q in
                            zip(scann.train_buckets, routes) if q == r)
                 for r in ("fused", "loop", "per_layer")}
        for c in counters.values():
            kbwd.reset_counts(c)
        t1 = time.time()
        hist = scann.train()
        torch.cuda.synchronize()
        got = {n: (c.launches, c.bf16_launches) for n, c in counters.items()}
        wide, tall = counters[4].wide_launches, counters[4].tall_launches
        print(f"phase 15 {label}: launches by schedule #2 {mode_counts(counters[2])}, #4 "
              f"{mode_counts(counters[4])} ({wide} wide, {tall} tall)", flush=True)
        seconds = time.time() - t1
        after = set_loss()                             # before evaluate() restores "best"
        result = scann.evaluate()
        print(f"phase 15 {label}: buckets {[(b.shape, r) for b, r in zip(buckets, routes)]}, "
              f"steps by route {steps}, epoch losses {hist['loss']}, training-set loss without "
              f"dropout {before:.6f} -> {after:.6f}, test {result}; launches (all, bf16) #2 "
              f"{got[2]}, #4 {got[4]}; {seconds:.1f} s  [{card}]", flush=True)
        if not (np.isfinite(hist["loss"]).all() and hist["loss"][-1] < hist["loss"][0]
                and np.isfinite(after) and after < before):
            failures.append(f"phase 15 {label}: epoch losses {hist['loss']}, training-set loss "
                            f"{before} -> {after}: not finite and falling")
        wide_steps = steps["loop"] if multiple > 32 else 0
        if (want not in routes or got[2] != (steps["fused"],) * 2
                or got[4] != (steps["loop"],) * 2 or (wide, tall) != (wide_steps, 0)):
            failures.append(f"phase 15 {label}: routes {routes} (want {want}), launches {got} "
                            f"({wide} wide, {tall} tall) for steps {steps}")
        launches[2] += got[2][1]
        launches[4] += got[4][1] - wide - tall
        launches["scann_loop_backward_wide_bf16"] += wide
        return scann, cfg

    energy_t = "formation_energy_per_atom"
    qm9, cfg = train("bf16 QM9", qm9_model, qm9_run, "homo", 128, 8, "fused")
    # resume: one step of the trainer put back in "last" and of a Scann
    # loaded from it, on the same rows, lr and dropout seed: bit for bit
    trainer = qm9.trainer
    last = os.path.join(trainer.workdir, "checkpoints", "last")
    resumed = Scann(ScannConfig.from_dict(cfg.to_dict()), pretrained=last, device="cuda")
    trainer.restore_checkpoint("last")
    b = qm9.train_buckets[-1]
    idx, seeds = trainer.epoch_plan(cfg.hyper.epochs, len(qm9.train_buckets) - 1,
                                    b.num_structures, 128)
    rows = idx[0].cuda()
    lr = cfg.hyper.lr / (1.0 + cfg.hyper.adam_decay * trainer.step)
    before = kbwd.launch_scann_backward.bf16_launches
    for t in (trainer, resumed.trainer):
        (binputs, btargets), = t._put_buckets([b], "resume")
        t.train_step({k: v[rows] for k, v in binputs.items()}, btargets[rows], lr, seeds[0])
    torch.cuda.synchronize()
    launches[2] += kbwd.launch_scann_backward.bf16_launches - before
    pairs = [(getattr(trainer, a), getattr(resumed.trainer, a)) for a in ("params", "mu", "nu")]
    equal = sum(torch.equal(p[k], q[k]) for p, q in pairs for k in p)
    total = sum(len(p) for p, _ in pairs)
    print(f"phase 15 bf16 QM9: resumed through load_pretrained(checkpoints/last): one step in "
          f"both, {equal} of {total} tensors (params, mu, nu) equal, #2 bf16 launches "
          f"{kbwd.launch_scann_backward.bf16_launches - before} for the 2 steps", flush=True)
    if (equal != total or resumed.trainer.step != trainer.step
            or kbwd.launch_scann_backward.bf16_launches - before != 2):
        failures.append(f"phase 15: the bf16 step after load_pretrained differs: {equal} of "
                        f"{total} tensors equal")
    del qm9, resumed, trainer
    train("bf16 MP2018", mp2018, crystal_run, energy_t, 64, 32, "loop")
    train("bf16 MP2018 N=64", mp2018, crystal_run, energy_t, 64, 64, "loop")
    return launches


def phase15(matrix, qm9_model, mp2018, qm9_inputs, packed_qm9, qm9_run, crystal_run, failures,
            card):
    """model.dtype bfloat16 training: the holds (``phase15_matrix``,
    ``phase15_holds``), the times (``phase15_times``) and the main path
    (``phase15_train``). Returns the rows ``2-bf16`` and ``4-bf16`` of the
    {"kernels": ...} line, and the launches of #4's wide build in bf16
    (``4-wide-bf16``) on the main path."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    t0 = time.time()
    small = phase15_matrix(matrix, failures)
    worst, mp_x = phase15_holds(qm9_model, mp2018, qm9_inputs, packed_qm9, failures)
    worst = {n: max(worst[n], small[n]) for n in worst}
    times = phase15_times(qm9_model, mp2018, qm9_inputs, mp_x, card)
    del mp_x
    torch.cuda.empty_cache()
    launches = phase15_train(qm9_model, mp2018, qm9_run, crystal_run, failures, card)
    wide = launches.pop("scann_loop_backward_wide_bf16")
    print(f"phase 15 main path: bf16 launches #2 {launches[2]}, #4 {launches[4]} narrow and "
          f"{wide} wide; {time.time() - t0:.1f} s  [{card}]", flush=True)
    if min(launches.values()) == 0 or wide == 0:
        failures.append(f"phase 15: a backward kernel was not launched in bf16 on the main path: "
                        f"{launches}, {wide} wide")
    rows = [bf16_row(f"{n}-bf16", kernel, source,
                     mod.REPLACES if n == 2 else mod.BACKWARD_REPLACES, launches[n], worst[n],
                     times[n][0], times[n][1], *times[n][2:], card)
            for n, kernel, source, mod in (
                (2, "scann_backward", "scann_tpu_torch/csrc/scann_backward_bf16.cu", kbwd),
                (4, "scann_loop_backward", "scann_tpu_torch/csrc/scann_loop_backward_bf16.cu",
                 kloop))]
    return {"scann_loop_backward_wide_bf16": wide}, rows


# ---- phase 16: the activation stashes of #2 and #4 -------------------------------------

STASH_GAP = 0.1      # a bf16 stash's mean distance from its plain version, of the plain gap
STASH_FLOOR = 2.0    # ... or of the f32 kernel's distance from the f32 plain version
STASH_BELOW = 0.5    # ... and at most this of the recompute kernel's from the bf16 plain version


def hold_bf16_stash(label, got, plain16, plain32, rec, failures):
    """A bf16 stash launch against its plain version (the reverse walk of
    ``kbwd.reference_stash_*`` / ``kloop.reference_loop_stash_*``), each a
    (pred, gradients) pair, the gradients flattened into one vector: (a) its
    mean distance from the plain bf16-stash gradient, (b) the plain bf16
    stash's own mean distance from the plain f32 gradient, (c) the f32-noise
    floor, the recompute kernel's distance from the plain f32 gradient, and
    (d) the recompute kernel's distance from the plain bf16-stash gradient,
    what a kernel that ignored the stash's rounding reads. Holds (a) to the
    larger of ``STASH_GAP`` x (b) and ``STASH_FLOOR`` x (c), and to
    ``STASH_BELOW`` x (d); pred within the forward's rtol and atol."""
    flat = lambda g: torch.cat([g[k].double().reshape(-1) for k in sorted(g)])
    dist = lambda u, v: (u - v).abs().mean().item()
    k16, p16, p32, k32 = (flat(o[1]) for o in (got, plain16, plain32, rec))
    a, b, c, d = dist(k16, p16), max(dist(p16, p32), 1e-30), dist(k32, p32), dist(k32, p16)
    limit = min(max(STASH_GAP * b, STASH_FLOOR * c), STASH_BELOW * d)
    pred_ok = bool(((got[0] - plain16[0]).abs() <= ATOL + RTOL * plain16[0].abs()).all())
    ok = a <= limit and pred_ok and bool(torch.isfinite(k16).all())
    print(f"{label}: (a) {a:.3e} = {a / b:.4f} x (b) {b:.3e}, (c) {c / b:.4f} x, (d) {d / b:.4f} "
          f"x; limit {limit / b:.4f} x; pred within rtol {RTOL} atol {ATOL}: {pred_ok}",
          flush=True)
    if not ok:
        failures.append(f"{label}: (a) {a:.3e} over {limit:.3e} or pred off ({pred_ok})")
    return (k16 - p16).abs().max().item()


def phase16(qm9_model, mp2018, ptgp, qm9_inputs, packed_qm9, mp_packed, main, held, failures,
            card):
    """The activation stashes of the two backward kernels (the TPU kernels'
    default training schedules): #4's selective stash at MP2018 (64, 96, 32)
    (2 blocks a structure), Pt/graphene (64, 128, 32), QM9 packed at
    capacity 48 and MP2018 packed at 96; #2's keep-acts stash at QM9 (128,
    32, 16) and packed at 32.
    At dropout 0.1, each: the f32 stash bit for bit against the recompute
    launch, in f32 and in the bf16 operand mode; the bf16 stash against its
    plain version (``hold_bf16_stash``); #4's bf16 stash relaunched on NaN-
    and constant-filled scratch at 1, 2 and 4 blocks a structure, bit for
    bit. Each shape times the f32 stash in turns with the recompute schedule
    (3 + 8 reps), the unpacked shapes the bf16 stash too. Then the bf16
    stashes on the main path, through
    the public entry points, with their switches set: #2 at QM9 under
    ``SCANN_TPU_STASH_BF16=1`` and #4 at Pt/graphene's batch of 128, whose
    f32 stash exceeds the budget, under ``SCANN_TPU_LOOP_STASH_BF16=1``
    (counts set to 0 just before, read just after). ``main``: the launches
    of #2 and #4 on the main training paths (phases 5 and 10) by schedule
    (``schedules``); ``held``: the largest absolute errors of phases 4 and 9,
    whose launches took the f32 stash. Returns the stash rows of the
    ``{"kernels": ...}`` line, and the largest absolute errors of the
    recompute launches (rows ``scann_backward``, ``scann_loop_backward``)
    against the plain f32 versions."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    t0 = time.time()
    rng = np.random.default_rng(16)
    mp_x = synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20)
    pt_x = synthetic_batch(rng, 64, 128, 32, use_ring=True, n_atoms=ptgp.n_atoms, min_atoms=20)
    plains = {2: (kbwd.reference_fused_scann_train_grads, kbwd.reference_stash_train_grads),
              4: (kloop.reference_loop_train_grads, kloop.reference_loop_stash_train_grads)}
    cases = ((4, mp2018, "mp2018", mp_x, 16), (4, ptgp, "ptgp", pt_x, 16),
             (4, qm9_model, "qm9 capacity 48", packed_qm9[48], 64),
             (4, mp2018, "mp2018 capacity 96", mp_packed, 16),
             (2, qm9_model, "qm9", qm9_inputs, 128),
             (2, qm9_model, "qm9 capacity 32", packed_qm9[32], 128))
    worst = {2: 0.0, 4: 0.0}
    err = {(n, m): held.get(n, 0.0) if m == "f32" else 0.0 for n in (2, 4)
           for m in ("f32", "recompute")}
    times = {}
    for n, cfm, label, x, chunk in cases:
        params = init_params(cfm, torch.Generator().manual_seed(16), "cuda")
        packed = kfwd.pack_params(params, cfm)
        kfwd._check_inputs(x, cfm, packed["wde"].device)
        B, M = x["atomic"].shape[:2]
        N = x["neighbors"].shape[2]
        S = max(kfwd.segment_count(x), 1)
        y = torch.from_numpy(rng.normal(size=(B, S)).astype(np.float32)).cuda()
        cfm16 = dataclasses.replace(cfm, dtype="bfloat16")
        tag = f"phase 16 #{n} {label} B={B} M={M} N={N}{packed_label(x)} dropout 0.1"
        run = lambda mode, c=cfm: backward_launch(n, packed, x, y, c, 0.1, 16, stash=mode)
        got = {(c.dtype, mode): run(mode, c) for c in (cfm, cfm16) for mode in (None, "f32")}
        got["float32", "bf16"] = run("bf16")
        torch.cuda.synchronize()
        line = [tag]
        for dtype in ("float32", "bfloat16"):
            r, f = got[dtype, None], got[dtype, "f32"]
            differ = [k for k in r[1] if not torch.equal(r[1][k], f[1][k])]
            if not torch.equal(r[0], f[0]):
                differ.append("pred")
            line.append(f"{dtype} operands: the f32 stash bit-equal to the recompute launch: "
                        f"{not differ}")
            if differ:
                failures.append(f"{tag} ({dtype} operands): the f32 stash differs from the "
                                f"recompute launch in {differ[:6]}")
        print("  ".join(line), flush=True)
        plain32 = chunked_train_grads(plains[n][0], params, x, y, cfm, False, 0.1, 16, chunk)
        plain16 = chunked_train_grads(plains[n][1], params, x, y, cfm, False, 0.1, 16, chunk)
        worst[n] = max(worst[n], hold_bf16_stash(f"{tag}: the bf16 stash", got["float32", "bf16"],
                                                 plain16, plain32, got["float32", None],
                                                 failures))
        for m, mode in (("recompute", None), ("f32", "f32")):
            out = got["float32", mode]
            err[n, m] = max(err[n, m], (out[0] - plain32[0]).abs().max().item(),
                            grad_errors(out[1], plain32[1])[2])
        del got, plain16, plain32
        if n == 4 and label == "mp2018":
            differ = set()
            for C in (1, 2, 4):
                scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, C, "bf16")
                first = None
                for fill in (None, float("nan"), -3.0):
                    if fill is not None:
                        for t in scratch.values():
                            if t is not None:
                                t.fill_(fill)
                    out = backward_launch(n, packed, x, y, cfm, 0.1, 16, scratch, C, stash="bf16")
                    out = (out[0].clone(), {k: v.clone() for k, v in out[1].items()})
                    if first is None:
                        first = out
                        continue
                    differ |= {f"{k} at C={C}" for k in first[1]
                               if not torch.equal(first[1][k], out[1][k])}
                    if not torch.equal(first[0], out[0]):
                        differ.add(f"pred at C={C}")
                del scratch
            print(f"{tag}: the bf16 stash relaunched on NaN- and constant-filled scratch at 1, "
                  f"2 and 4 blocks a structure bit-identical: {not differ}", flush=True)
            if differ:
                failures.append(f"{tag}: bf16-stash relaunches differ in {sorted(differ)[:6]}")
        # ---- each stash in turns with the recompute schedule (packed: the f32 stash,
        # the packed paths' schedule) ---------------------------------------------------
        modes = ("f32",) if S > 1 else ("f32", "bf16")
        scratch = {m: (kloop.loop_backward_scratch(packed, cfm, B, M, N, None, m)
                       if n == 4 else None) for m in (None, *modes)}
        launch = lambda m: backward_launch(n, packed, x, y, cfm, 0.1, 16, scratch[m], stash=m)
        t = {m: in_turns_ms(lambda: launch(None), lambda m=m: launch(m), 3, 8) for m in modes}
        plain_ms = {m: statistics.median(cuda_times(lambda m=m: chunked_train_grads(
            plains[n][m == "bf16"], params, x, y, cfm, False, 0.1, 16, chunk), 2, warmup=1))
            for m in modes}
        _, P = kbwd.grad_layout(packed)
        nbytes = tensor_bytes(x.values(), weights(packed)) + 4 * B * S + 4 * (P + B * S)
        stash_bytes = {m: (kloop.loop_stash_bytes if n == 4 else kbwd.keep_acts_stash_bytes)(
            cfm, B, M, N, m) for m in modes}
        recompute = {m: (kloop.loop_recompute_flops if n == 4 else kbwd.recompute_flops)(
            cfm, B, M, N, m) for m in modes}
        times[n, label] = (t, plain_ms, kbwd.backward_flops(cfm, B, M, N),
                           kbwd.backward_fp32_flops(cfm, B, M, N), nbytes, stash_bytes,
                           recompute)
        for m in modes:
            print(f"phase 16 #{n} {label} B={B} M={M} N={N}{packed_label(x)} the {m} stash "
                  f"(dropout 0.1, one-shot; "
                  f"timed in turns: recompute, stash, stash, recompute): {t[m][0]:.4f} ms against "
                  f"the recompute schedule's {t[m][1]:.4f} ms ({100 * (t[m][0] / t[m][1] - 1):+.1f}"
                  f"%); the stash {stash_bytes[m] / 1e9:.3f} GB written once and read once "
                  f"({2e3 * stash_bytes[m] / published_rates()[2]:.4f} ms at the "
                  f"published HBM rate); plain {plain_ms[m]:.4f} ms  [{card}]", flush=True)
        del scratch
    # ---- the bf16 stashes on the main path, through the public entry points ------------
    counters = {2: kbwd.launch_scann_backward, 4: kloop.launch_loop_backward}
    pt128 = synthetic_batch(rng, 128, 128, 32, use_ring=True, n_atoms=ptgp.n_atoms,
                            min_atoms=20)
    switched = ((2, qm9_model, "qm9", qm9_inputs, "SCANN_TPU_STASH_BF16",
                 kbwd.fused_scann_train_grads, 128),
                (4, ptgp, "ptgp B=128", pt128, "SCANN_TPU_LOOP_STASH_BF16",
                 kloop.loop_scann_train_grads, 16))
    bf16_main = {}
    for n, cfm, label, x, switch, entry, chunk in switched:
        params = init_params(cfm, torch.Generator().manual_seed(17), "cuda")
        B, M = x["atomic"].shape[:2]
        N = x["neighbors"].shape[2]
        y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        os.environ[switch] = "1"
        try:
            mode = (kloop.loop_stash_mode if n == 4 else kbwd.keep_acts_mode)(cfm, B, M, N)
            kbwd.reset_counts(counters[n])
            got = entry(params, x, y, cfm, False, 0.1, 16)
            torch.cuda.synchronize()
            bf16_main[n] = counters[n].bf16_stash_launches
            counts = mode_counts(counters[n])
        finally:
            del os.environ[switch]
        print(f"phase 16 main path: #{n} {label} under {switch}=1 (the mode rule says {mode}; "
              f"the f32 stash would take {(kloop.loop_stash_bytes if n == 4 else kbwd.keep_acts_stash_bytes)(cfm, B, M, N, 'f32') / 1e9:.3f} GB of "
              f"the {kbwd.STASH_BUDGET_BYTES / 2 ** 30:.0f} GiB budget): launches {counts}",
              flush=True)
        if mode != "bf16" or bf16_main[n] != 1:
            failures.append(f"phase 16 main path #{n} {label}: mode {mode}, bf16-stash launches "
                            f"{bf16_main[n]} (want 1)")
        plain16 = chunked_train_grads(plains[n][1], params, x, y, cfm, False, 0.1, 16, chunk)
        plain32 = chunked_train_grads(plains[n][0], params, x, y, cfm, False, 0.1, 16, chunk)
        rec = backward_launch(n, kfwd.pack_params(params, cfm), x, y, cfm, 0.1, 16, stash=None)
        worst[n] = max(worst[n], hold_bf16_stash(f"phase 16 main path #{n} {label}", got,
                                                 plain16, plain32, rec, failures))
        del got, plain16, plain32, rec
    print(f"phase 16: {time.time() - t0:.1f} s  [{card}]", flush=True)
    rows = []
    for n, mod, label, packed_cases in ((2, kbwd, "qm9", ("qm9 capacity 32",)),
                                        (4, kloop, "mp2018",
                                         ("qm9 capacity 48", "mp2018 capacity 96"))):
        t, plain_ms, flops, fp32, nbytes, stash_bytes, recompute = times[n, label]
        for m in ("f32", "bf16"):
            bound, by, measured = bound_ms(flops, nbytes, fp32)
            row = {"name": f"{n}-stash" + ("-bf16" if m == "bf16" else ""),
                   "kernel": "scann_loop_backward" if n == 4 else "scann_backward",
                   "schedule": m, "route": "cuda",
                   "source": mod.BACKWARD_SOURCE if n == 4 else mod.SOURCE,
                   "replaces": mod.BACKWARD_REPLACES if n == 4 else mod.REPLACES,
                   "launches": main[n]["f32"] if m == "f32" else bf16_main[n],
                   "max_abs_err": err[n, "f32"] if m == "f32" else worst[n],
                   "ms": t[m][0], "recompute_ms": t[m][1],
                   "plain_ms": plain_ms[m], "bound_ms": bound, "bound_by": by,
                   "measured_bound_ms": measured, "library_ms": None, "flops": flops,
                   "recompute_flops": recompute[m], "stash_bytes": 2 * stash_bytes[m],
                   "stash_ms": 2e3 * stash_bytes[m] / published_rates()[2],
                   "measured_stash_ms": (2e3 * stash_bytes[m] / (MEASURED["hbm_gbps"] * 1e9)
                                         if MEASURED else None)}
            if n == 4:
                pt, pt_plain = times[4, "ptgp"][0][m], times[4, "ptgp"][1][m]
                row["ptgp"] = {"ms": pt[0], "recompute_ms": pt[1], "plain_ms": pt_plain}
            if m == "f32":      # keyed as rows scann_backward and scann_loop_backward key it
                packed_times = {}
                for case in packed_cases:
                    pt, pt_plain, p_flops, p_fp32, p_bytes = times[n, case][:5]
                    p_bound, p_by, p_measured = bound_ms(p_flops, p_bytes, p_fp32)
                    packed_times[case] = {"ms": pt["f32"][0], "recompute_ms": pt["f32"][1],
                                          "plain_ms": pt_plain["f32"], "bound_ms": p_bound,
                                          "bound_by": p_by, "measured_bound_ms": p_measured,
                                          "flops": p_flops}
                row["packed"] = packed_times if n == 4 else packed_times[packed_cases[0]]
            rows.append(row)
    return rows, {n: err[n, "recompute"] for n in (2, 4)}


def phase9(matrix, mp2018, ptgp, qm9_model, packed_batches, failures, card):
    """The crystal loop-backward kernel against its plain version (the eager
    training forward under torch.autograd, same Philox masks), at 1, 2 and 4
    blocks per structure: a small matrix in cotangent and one-shot mode at
    dropout 0 and 0.1, the atom blocks of 16 and 8, structures with fewer
    atoms than blocks and with unequal shares, then MP2018 (N=32 and N=16)
    and Pt/graphene at full width, with relaunches on garbage-filled scratch
    held bit for bit at every cluster size, and its time. Returns (largest
    abs error, timing of the MP2018 (96, 32) shape)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(9)
    prng = np.random.default_rng(90)       # the packed batches' draws
    worst = 0.0
    every = kloop.CLUSTER_SIZES[::-1]      # (1, 2, 4)

    def compare(name, cfm, x, mrelu=False, rate=0.0, cotangent=True, relaunches=0,
                clusters=None):
        nonlocal worst
        B, M = x["atom_mask"].shape[:2]
        S = max(kfwd.segment_count(x), 1)
        r = prng if S > 1 else rng
        p = init_params(cfm, torch.Generator().manual_seed(9), "cuda")
        y = torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda()
        ct = None
        if cotangent:
            ct = (torch.from_numpy(r.normal(size=(B, S)).astype(np.float32)).cuda(),
                  torch.from_numpy(r.normal(size=(B, M, 1)).astype(np.float32)).cuda())
        worst = max(worst, hold_loop_backward(f"phase 9 {name}", cfm, p, x, y, mrelu, rate, 11,
                                              failures, ct, relaunches, clusters))

    cases = list(matrix) + [("scann+ use_drop", dataclasses.replace(matrix[0][1], use_drop=True),
                             False)]
    for name, cfm, mrelu in cases:
        # M=40: an atom block of 32 and one of 8 at one block per structure, shares of 20
        # and 10 atoms at 2 and 4; single-atom structures allowed
        x = synthetic_batch(rng, 6, 40, 8, cfm.use_ring, cfm.feature == "cgcnn", min_atoms=1)
        compare(name, cfm, x, mrelu, 0.0)
        compare(name, cfm, x, mrelu, 0.1, relaunches=2, clusters=every)
    compare("scann+ one atom per chunk", matrix[0][1], synthetic_batch(rng, 4, 72, 24), rate=0.1,
            clusters=every)
    lone = synthetic_batch(rng, 4, 72, 8)
    lone["atom_mask"][0] = 0.0
    lone["atom_mask"][0, 0] = 1.0
    lone["neighbor_mask"][0] = 0.0
    compare("scann+ one-atom structure", matrix[0][1], lone, relaunches=2, clusters=every)
    # M=3 at 4 blocks per structure: the last block has no atom and a row of zeros
    compare("scann+ fewer atoms than blocks", matrix[0][1],
            synthetic_batch(rng, 4, 3, 8, min_atoms=1), rate=0.1, relaunches=2, clusters=every)
    # M=90: shares of 45 + 45 and of 23 + 23 + 23 + 21 atoms, atom blocks of 32 + 13 in a share
    compare("mp2018 full width, unequal shares", mp2018,
            synthetic_batch(rng, 4, 90, 32, n_atoms=mp2018.n_atoms, min_atoms=40),
            rate=0.1, cotangent=False, relaunches=4, clusters=every)
    for M in (160, 208, 226):   # atom blocks of 16 and of 8, the last M the gate takes
        compare("mp2018 full width", mp2018,
                synthetic_batch(rng, 4, M, 32, n_atoms=mp2018.n_atoms, min_atoms=100),
                rate=0.1, cotangent=False, relaunches=4, clusters=every)
    # mostly padding: structures of 3 atoms up in the block-16 and block-8 buckets
    for M in (160, 208):
        compare("mp2018 full width, ragged", mp2018,
                synthetic_batch(rng, 4, M, 32, n_atoms=mp2018.n_atoms), rate=0.1,
                cotangent=False, relaunches=4, clusters=every)
    mp_inputs = synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20)
    compare("mp2018 full width", mp2018, mp_inputs, rate=0.1, relaunches=4, clusters=(1, 2))
    # N=16: two atoms per chunk of rows, the shape of phase 10's one-bucket run
    mp16_inputs = synthetic_batch(rng, 64, 96, 16, n_atoms=mp2018.n_atoms, min_atoms=20)
    compare("mp2018 full width", mp2018, mp16_inputs, rate=0.1, relaunches=4, clusters=(1, 2))
    ptgp_inputs = synthetic_batch(rng, 64, 128, 32, use_ring=True, n_atoms=ptgp.n_atoms,
                                  min_atoms=20)
    compare("ptgp full width", ptgp, ptgp_inputs, rate=0.1, relaunches=4, clusters=(1, 2))
    # packed slots: the small matrix in slots of 16 rows; the flagship QM9 packing
    # (capacity 48, whose step this kernel takes) and MP2018-like crystals at capacity
    # 96, up to 8 segments a slot, at 1, 2 and 4 blocks per structure
    for name, cfm, mrelu in matrix:
        compare(name, cfm, pack_batch(synthetic_batch(prng, 12, 8, 8, cfm.use_ring,
                                                      cfm.feature == "cgcnn"), 16),
                mrelu, 0.1, relaunches=2, clusters=every)
    compare("qm9 full width capacity 48", qm9_model, packed_batches["qm9"], rate=0.1,
            relaunches=4, clusters=every)
    compare("mp2018 full width capacity 96", mp2018, packed_batches["mp2018"], rate=0.1,
            relaunches=4, clusters=every)

    timing = None
    packed_timing = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, cfm, x in (("mp2018", mp2018, mp_inputs), ("ptgp", ptgp, ptgp_inputs),
                         ("mp2018", mp2018, mp16_inputs),
                         ("qm9 capacity 48", qm9_model, packed_batches["qm9"]),
                         ("mp2018 capacity 96", mp2018, packed_batches["mp2018"])):
        params = init_params(cfm, torch.Generator().manual_seed(0), "cuda")
        packed = kfwd.pack_params(params, cfm)
        B, M = x["atom_mask"].shape[:2]
        N = x["neighbors"].shape[2]
        S = max(kfwd.segment_count(x), 1)
        C = kloop.cluster_size(B)
        y = torch.from_numpy(np.random.default_rng(1).normal(size=(B, S)).astype(np.float32)
                             ).cuda()
        kloop.check_backward_supported(cfm, M, N)
        kfwd._check_inputs(x, cfm, packed["wde"].device)
        scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, stash=None)
        ms, plain_ms = in_turns_ms(
            lambda: kloop.reference_loop_train_grads(params, x, y, cfm, False, 0.1, 7),
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch, stash=None), 3, 8)
        flops = kloop.loop_backward_flops(cfm, B, M, N)
        recompute = kloop.loop_recompute_flops(cfm, B, M, N)
        _, P = kbwd.grad_layout(packed)
        nbytes = tensor_bytes(x.values(), weights(packed)) + 4 * B * S + 4 * (P + B * S)
        bound, by, measured = bound_ms(flops, nbytes, kbwd.backward_fp32_flops(cfm, B, M, N))
        scratch_bytes = tensor_bytes(scratch.values())
        print(f"scann_loop_backward at {name} B={B} M={M} N={N}{packed_label(x)} "
              f"L={cfm.n_attention} (the recompute schedule; dropout "
              f"0.1, one-shot, with its row reduction; timed in turns: plain, kernel, kernel, "
              f"plain): kernel {ms:.4f} ms on {B} clusters of {C} blocks on {sms} SMs "
              f"({kloop.max_active_clusters(cfm, B, M, N, C)} such clusters run at once), plain "
              f"{plain_ms:.4f} ms, {flops:.4e} FLOP, {nbytes} bytes, bound {bound:.4f} ms by {by} "
              f"({100 * bound / ms:.1f}% of it reached); the schedule adds {recompute:.4e} FLOP "
              f"of recompute, which the bound does not count; scratch "
              f"{scratch_bytes / 2 ** 20:.0f} MiB  [{card}]", flush=True)
        del scratch
        if S > 1:
            packed_timing[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                   "bound_by": by, "measured_bound_ms": measured, "flops": flops}
        elif timing is None:
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                      "measured_bound_ms": measured, "flops": flops,
                      "recompute_flops": recompute, "cluster": C}
            # what the cluster gives: the same batch at one block per structure, and the
            # batch doubled (one block per structure: 128 blocks either way)
            one = kloop.loop_backward_scratch(packed, cfm, B, M, N, 1, None)
            ms1 = cuda_ms(lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False,
                                                         0.1, 7, 0, one, 1, None), reps=10)
            del one
            twice = {k: torch.cat([v, v]) for k, v in x.items()}
            y2 = torch.cat([y, y])
            C2 = kloop.cluster_size(2 * B)
            two = kloop.loop_backward_scratch(packed, cfm, 2 * B, M, N, stash=None)
            ms2 = cuda_ms(lambda: kloop._launch_backward(packed, twice, cfm, y2, None, True,
                                                         False, 0.1, 7, 0, two, stash=None),
                          reps=10)
            del two, twice
            timing["ms_one_block"], timing["ms_batch_doubled"] = ms1, ms2
            print(f"scann_loop_backward at {name} B={B}: {ms1:.4f} ms at one block per "
                  f"structure ({ms1 / ms:.2f}x the time of {C}); with the batch doubled to "
                  f"B={2 * B} ({C2} block per structure) {ms2:.4f} ms, {ms2 / ms:.2f}x the time "
                  f"of B={B} for twice the work  [{card}]", flush=True)
    at_once = {c: kloop.max_active_clusters(mp2018, 64, 96, 32, c) for c in every}
    print(f"scann_loop_backward clusters that run at once at the MP2018 shape, by blocks per "
          f"structure: {at_once} (the wrapper's rule counts on {kloop.CLUSTERS_AT_ONCE}; fewer "
          f"would cost a second wave, not the result)", flush=True)
    print(f"phase 9: worst loop-backward abs error (pred and gradients) {worst:.3e}  [{card}]",
          flush=True)
    timing["packed"] = packed_timing
    return worst, timing


def plain_loop_trainer():
    """The Trainer class with the plain version of the crystal backward in
    place of every kernel step (the loop route's ``reference_loop_train_grads``
    on the same rows, parameters and dropout seed)."""
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.train.loop import Trainer

    class PlainTrainer(Trainer):
        """The same Trainer with the plain version of every backward."""

        def raw_grads(self, batch, y, seed):
            pred, raw = kloop.reference_loop_train_grads(
                self.params, batch, y, self.config.model, self.mrelu_head,
                self.dropout_rate, seed)
            return pred[:, 0], raw

    return PlainTrainer


def phase10(mp2018, failures, card):
    """The crystal training path: 2 epochs through Scann.prepare_dataset ->
    train -> evaluate on synthetic periodic crystals of 20-90 sites at the
    full width and depth of the MP2018 model, batch 64, the recipe's 4
    buckets; the same run with the plain step; load_model_infer; and one
    training step by the per-layer route of the model without the attention
    LayerNorm, which the loop backward refuses. Returns (the loop-backward
    launches of the main path, its run directory)."""
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.train.loop import Trainer, _to_device

    PlainTrainer = plain_loop_trainer()
    work = tempfile.mkdtemp(prefix="scann_chip_smoke_crystals_")
    n_crystals = 480       # host Voronoi of periodic cells: 0.065-0.085 s a crystal
    t0 = time.time()
    energy, nbr = make_synthetic_dataset(work, "mplike", n_structures=n_crystals, min_atoms=20,
                                         max_atoms=90, periodic=True, seed=0,
                                         target_names=("formation_energy_per_atom",))
    print(f"phase 10: {n_crystals} synthetic periodic crystals (20-90 sites of Si, O, Al, Fe, "
          f"Mg) written and featurized on the host in {time.time() - t0:.1f} s", flush=True)

    bs = 64

    def config(name, max_buckets, neighbors_multiple):
        return ScannConfig(model=mp2018,
                           hyper=HyperConfig(batch_size=bs, scheduler="sgdr", lr=5e-4,
                                             min_lr=1e-4, target="formation_energy_per_atom",
                                             data_energy_path=energy, data_nei_path=nbr,
                                             epochs=2, seed=0,
                                             save_path=os.path.join(work, name)),
                           tpu=TpuConfig(max_buckets=max_buckets,
                                         neighbors_pad_multiple=neighbors_multiple))

    def hold_first_batches(label, trainer, buckets):
        """The loop-backward kernel against its plain version on the first
        batch that training takes from each bucket: its rows, its dropout
        seed, the trainer's parameters."""
        for bi, b in enumerate(buckets):
            if trainer.train_route(*b.shape) != "loop":
                continue
            idx, seeds = trainer.epoch_plan(0, bi, b.num_structures, bs)
            x = _to_device(b.inputs, trainer.device)
            x = {k: v[idx[0].to(trainer.device)] for k, v in x.items()}
            y = torch.as_tensor(np.asarray(b.targets, np.float32))[idx[0]].to(trainer.device)
            hold_loop_backward(f"phase 10 {label}, bucket {bi}'s first batch", mp2018,
                               trainer.params, x, y, trainer.mrelu_head, trainer.dropout_rate,
                               seeds[0], failures, relaunches=2)

    # ---- the main path: the MP2018 recipe's buckets (max_buckets: 4). The
    # jittered-grid crystals have at most 16 Voronoi neighbours, MP2018's have
    # up to 32: the neighbour axis is padded to the recipe's width, so the
    # largest bucket is the recipe's (96, 32)
    cfg = config("run", 4, 32)
    scann = Scann(cfg, device="cuda")
    scann.prepare_dataset()
    buckets = scann.train_buckets
    trainer = scann.trainer
    batches = lambda bb: sum(-(-b.num_structures // bs) for b in bb)
    train_routes = [trainer.train_route(*b.shape) for b in buckets]
    steps = {r: 2 * batches([b for b, q in zip(buckets, train_routes) if q == r])
             for r in ("fused", "loop", "per_layer")}
    eval_batches = {r: 0 for r in ("fused", "loop", "per_layer")}
    for times, bb in ((2, scann.valid_buckets), (1, scann.test_buckets)):
        for b in bb:
            eval_batches[trainer.eval_route(*b.shape)] += times * batches([b])
    scann.init_params(cfg.hyper.seed)              # what fit() would draw
    hold_first_batches("main path", trainer, buckets)
    passes = trace_passes(trainer, buckets)
    step_ms = []
    train_step = trainer.train_step

    def timed_step(*args):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = train_step(*args)
        e.record()
        step_ms.append((s, e))
        return out

    trainer.train_step = timed_step
    counters = (kbwd.launch_scann_backward, kloop.launch_loop_backward,
                kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)
    for c in counters:
        c.launches = 0                               # counts of the training path only
    kbwd.reset_counts(kbwd.launch_scann_backward)
    kbwd.reset_counts(kloop.launch_loop_backward)
    t1 = time.time()
    hist = scann.train()
    final = bucket_losses(trainer, buckets)        # before evaluate() restores "best"
    result = scann.evaluate()
    torch.cuda.synchronize()
    fused_bwd, loop_bwd, fused_fwd, loop_fwd, layer_fwd = (c.launches for c in counters)
    by_schedule = schedules(kloop.launch_loop_backward)
    print(f"phase 10: #4 launches by schedule {mode_counts(kloop.launch_loop_backward)}",
          flush=True)
    if by_schedule["f32"] == 0:
        failures.append("phase 10: no launch of #4 with the f32 selective stash on the main path")
    del trainer.train_step, trainer.epoch_plan
    med = statistics.median(s.elapsed_time(e) for s, e in step_ms)
    n_train = sum(b.num_structures for b in buckets)
    shapes = [(b.shape, b.num_structures, r) for b, r in zip(buckets, train_routes)]
    print(f"phase 10: buckets {shapes}, {len(step_ms)} steps in {time.time() - t1:.1f} s, losses {hist['loss']}, val_mae "
          f"{hist['val_mae']}, test {result}", flush=True)
    print(f"phase 10: median train step {med:.4f} ms (CUDA events), epoch 2 "
          f"{n_train / hist['epoch_time'][1]:.1f} structures/s (the per-pass probes included); "
          f"loop-backward launches {loop_bwd} for {steps['loop']} steps, molecule-backward "
          f"launches {fused_bwd} for {steps['fused']}; eval launches: molecule {fused_fwd}, "
          f"loop {loop_fwd}, per-layer {layer_fwd} for eval batches {eval_batches}  [{card}]",
          flush=True)
    if not all(np.isfinite(hist["loss"])):
        failures.append(f"crystal training loss not finite: {hist['loss']}")
    # A pass over one of four buckets is two steps, and they ride on the Adam
    # momentum of the other buckets' steps, so a pass need not lower its own
    # bucket's loss here (the plain step's run below does the same); the
    # one-bucket run further down is the one held to a falling loss.
    check_passes("kernel", passes, final, None, "phase 10")
    if (loop_bwd == 0 or loop_bwd != steps["loop"] or fused_bwd != steps["fused"]
            or steps["per_layer"] or len(step_ms) != sum(steps.values())):
        failures.append(f"backward launches do not match the routes: loop {loop_bwd}, molecule "
                        f"{fused_bwd} for steps {steps}")
    if not any(b.shape == (96, 32) and r == "loop" for b, r in zip(buckets, train_routes)):
        failures.append(f"the recipe's bucket (96, 32) was not trained by the loop backward: "
                        f"{[b.shape for b in buckets]}")
    if (fused_fwd != eval_batches["fused"] or loop_fwd != eval_batches["loop"]
            or layer_fwd != mp2018.n_attention * eval_batches["per_layer"]):
        failures.append(f"eval launches (molecule {fused_fwd}, loop {loop_fwd}, per-layer "
                        f"{layer_fwd}) do not match the eval batches {eval_batches}")

    # ---- the same run with the plain step: the same losses -------------------
    plain = PlainTrainer(cfg, "cuda", os.path.join(work, "plain"))
    plain.init_state(cfg.hyper.seed)
    plain_passes = trace_passes(plain, buckets)
    plain_hist = plain.fit(buckets, scann.valid_buckets, log_fn=lambda *_: None)
    plain_final = bucket_losses(plain, buckets)
    check_passes("plain", plain_passes, plain_final, None, "phase 10")
    mine = hist["loss"] + [x for p in passes for x in p[2]] + final
    ref = plain_hist["loss"] + [x for p in plain_passes for x in p[2]] + plain_final
    rel = max(abs(a - b) / abs(b) for a, b in zip(mine, ref))
    print(f"phase 10: the plain step's run: losses {plain_hist['loss']}; its epoch and "
          f"per-pass losses against the kernel's: max rel {rel:.3e} (limit {TRAIN_RTOL})",
          flush=True)
    if len(mine) != len(ref) or not rel <= TRAIN_RTOL:
        failures.append(f"kernel and plain two-epoch crystal runs differ: {rel:.3e}")
    del plain

    # a model loaded back from the run directory predicts what the trainer does
    p_trained = scann.predict_data(scann.test_buckets)
    loaded = Scann.load_model_infer(trainer.workdir, device="cuda")
    p_loaded = loaded.predict_data(scann.test_buckets)
    d = float(np.abs(p_trained - p_loaded).max())
    print(f"phase 10: load_model_infer predicts {len(p_loaded)} test crystals, max |d| {d:.3e} "
          f"from the trainer's predictions", flush=True)
    if not (np.isfinite(p_loaded).all() and d <= ATOL + RTOL * np.abs(p_trained).max()):
        failures.append(f"load_model_infer crystal predictions differ by {d:.3e}")
    del loaded

    # ---- one bucket: every pass (an epoch of 6 steps) lowers the loss ----------
    one = Scann(config("one", 1, 8), device="cuda")
    one.prepare_dataset()
    one.init_params(0)
    hold_first_batches("one bucket", one.trainer, one.train_buckets)
    one_passes = trace_passes(one.trainer, one.train_buckets)
    kloop.launch_loop_backward.launches = 0
    one_hist = one.train()
    one_final = bucket_losses(one.trainer, one.train_buckets)
    one_steps = 2 * batches(one.train_buckets)
    del one.trainer.epoch_plan
    check_passes("one bucket", one_passes, one_final, failures, "phase 10")
    n_one = sum(b.num_structures for b in one.train_buckets)
    print(f"phase 10 one bucket {[b.shape for b in one.train_buckets]}: epoch losses "
          f"{one_hist['loss']}, {kloop.launch_loop_backward.launches} loop-backward launches "
          f"for {one_steps} steps, epoch 2 {n_one / one_hist['epoch_time'][1]:.1f} structures/s"
          f"  [{card}]", flush=True)
    if not (all(np.isfinite(one_hist["loss"])) and one_hist["loss"][-1] < one_hist["loss"][0]
            and kloop.launch_loop_backward.launches == one_steps):
        failures.append(f"one-bucket crystal training: epoch losses {one_hist['loss']} not "
                        f"finite and falling, or {kloop.launch_loop_backward.launches} launches "
                        f"for {one_steps} steps")
    del one

    # ---- the third route: one step of a model the loop backward refuses ----
    # (MP2018 without the attention LayerNorm; with it the wide build takes
    # (248, 64) as the tall build takes every M at N <= 32)
    import dataclasses

    rng = np.random.default_rng(10)
    M, N, B = 248, 64, 8
    x = synthetic_batch(rng, B, M, N, n_atoms=mp2018.n_atoms, min_atoms=150)
    y = torch.from_numpy(rng.normal(size=B).astype(np.float32)).cuda()
    no_norm = dataclasses.replace(cfg, model=dataclasses.replace(mp2018, use_attn_norm=False))
    outcome = []
    for cls in (Trainer, PlainTrainer):
        t = cls(no_norm, "cuda", os.path.join(work, "third_" + cls.__name__))
        t.init_state(5)
        route = t.train_route(M, N)
        _, raw = t.raw_grads(x, y, 3)
        before = kla.fused_local_attention.launches, kloop.launch_loop_backward.launches
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        loss, _ = t.train_step(x, y, 5e-4, 3)
        e.record()
        e.synchronize()
        outcome.append((float(loss), raw, s.elapsed_time(e),
                        kla.fused_local_attention.launches - before[0],
                        kloop.launch_loop_backward.launches - before[1]))
    (loss_k, raw_k, ms_k, layer_n, loop_n), (loss_p, raw_p, ms_p, _, _) = outcome
    g_rel, g_key, _ = grad_errors(raw_k, raw_p)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"phase 10: one {route} training step at B={B} M={M} N={N} of MP2018 without the "
          f"attention LayerNorm (which the loop backward refuses; the plain model under "
          f"autograd, as the JAX Trainer trains): loss "
          f"{loss_k:.6f} vs plain step {loss_p:.6f} (rel {rel:.3e}, limit {LOSS_RTOL}), "
          f"gradients worst {g_rel:.2e} of max|plain| at {g_key}, {layer_n} per-layer kernel "
          f"launches (none wanted), {loop_n} loop-backward launches, {ms_k:.1f} ms (plain "
          f"step {ms_p:.1f} ms)  [{card}]", flush=True)
    if (route != "per_layer" or layer_n != 0 or loop_n != 0
            or not rel <= LOSS_RTOL or not g_rel <= GRAD_RTOL):
        failures.append(f"per-layer training step: route {route}, {layer_n} layer launches, "
                        f"{loop_n} loop-backward launches, loss rel {rel:.3e}, gradients "
                        f"{g_rel:.3e} at {g_key}")
    trace_steps(cfg, buckets[-1], os.path.join(work, "trace"), failures, card)
    return loop_bwd, trainer.workdir, {"schedules": by_schedule,
                                       "data": (energy, nbr), "work": work, "step_ms": med,
                                       "structures_s": n_train / hist["epoch_time"][1],
                                       "name": "phase 10"}


def trace_steps(cfg, bucket, logdir, failures, card):
    """Two training steps of a fresh Trainer on the first batch of
    ``bucket`` under ``utils.trace`` (``torch.profiler``, CPU and CUDA
    activities, as ``cli/train.py --profile`` runs it): the Chrome trace must
    be written. Prints its count of CUDA kernel events and the device ops
    with the most time; a trace without device events is printed as such
    (the profiler's CUDA activity needs CUPTI access to the card)."""
    import glob

    from scann_tpu_torch.train.loop import Trainer, _to_device
    from scann_tpu_torch.utils import trace

    trainer = Trainer(cfg, "cuda", os.path.join(logdir, "run"))
    trainer.init_state(0)
    idx, seeds = trainer.epoch_plan(0, 0, bucket.num_structures, cfg.hyper.batch_size)
    x = {k: v[idx[0].to(trainer.device)] for k, v in _to_device(bucket.inputs,
                                                                 trainer.device).items()}
    y = torch.as_tensor(np.asarray(bucket.targets, np.float32))[idx[0]].to(trainer.device)
    trainer.train_step(x, y, 5e-4, int(seeds[0]))            # outside the trace: warm
    torch.cuda.synchronize()
    t0 = time.time()
    with trace(logdir, python_tracer=False):
        for step in range(2):
            trainer.train_step(x, y, 5e-4, int(seeds[0]) + step)
        torch.cuda.synchronize()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    if not files:
        failures.append(f"trace: no Chrome trace written under {logdir}")
        return
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"trace: 2 training steps at {bucket.shape} (route {trainer.train_route(*bucket.shape)})"
          f" under utils.trace in {time.time() - t0:.1f} s: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0])} bytes, {len(events)} events, {len(kernels)} CUDA kernel "
          f"events  [{card}]", flush=True)
    if kernels:
        print("trace: device ops by time: " + "; ".join(
            f"{name[:60]} {us / 1e3:.3f} ms" for name, us in top), flush=True)
    else:
        print("trace: the trace holds no device events (torch.profiler's CUDA activity did not "
              "reach the card here); host events only", flush=True)


def _model_dict(cfm):
    import dataclasses

    return dataclasses.asdict(cfm)


def _run_shard_steps(trainer, steps, eval_batch, dev):
    """Phase 13's steps and eval batch on ``trainer``: {"losses", "params"
    (on the host), "pred", "ga" (on the host)} and the wall clock at the
    end of the first step."""
    from scann_tpu_torch.train.loop import _to_device

    losses, first = [], None
    for x, y, lr, seed in steps:
        loss, _ = trainer.train_step(_to_device(x, dev), y.to(dev), lr, seed)
        losses.append(loss.item())                 # waits for the step
        first = first or time.time()
    pred, ga = trainer.eval_batch(_to_device(eval_batch, dev))
    return {"losses": torch.tensor(losses),
            "params": {k: v.cpu() for k, v in trainer.params.items()},
            "pred": pred.cpu(), "ga": ga.cpu()}, first


APPLY_SEED = 7


def _apply_cotangents(spec, name):
    """The fixed cotangents phase 13 contracts the ``make_sharded_*_apply``
    outputs with (pred [B, 1], ga [B, M, 1] of ``spec``'s eval batch)."""
    B, M = spec[f"{name}_eval"]["atomic"].shape[:2]
    g = torch.Generator().manual_seed(17)
    return torch.randn(B, 1, generator=g), torch.randn(B, M, 1, generator=g)


def phase13_rank(rank, world, coordinator, spec_path, out_path, t_spawn):
    """One rank of phase 13 (``python3 chip_smoke.py --phase13-rank ...``):
    joins the gloo group, takes its kernels from the build cache the parent
    filled, runs the QM9 and MP2018 steps and eval batches as one rank of
    the Trainer's data parallelism (its sharded steps are the
    ``make_sharded_*_train`` wrappers, its loop eval
    ``make_sharded_loop_forward``), counts the launches, then calls the two
    ``make_sharded_*_apply`` wrappers on the eval batches at dropout 0.1
    and differentiates them, and writes what it got."""
    import torch.distributed as dist

    from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
    from scann_tpu_torch.kernels import _build, sharded
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.parallel import check_replicas_match, initialize, make_mesh
    from scann_tpu_torch.train.loop import Trainer, _to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    assert initialize(coordinator, world, rank, backend="gloo")
    spec = torch.load(spec_path, weights_only=True)
    cache = _build.set_build_dir(spec["cache_dir"])
    dev = torch.device(spec["device"])
    check_replicas_match({k: spec[k] for k in ("qm9_steps", "mp_steps")}, what="phase 13 batches")
    counters = (kfwd.fused_scann_forward, kbwd.launch_scann_backward, kloop.launch_loop_forward,
                kloop.launch_loop_backward, kla.fused_local_attention)
    for c in counters:
        c.launches = 0
    kbwd.reset_counts(kbwd.launch_scann_backward)
    kbwd.reset_counts(kloop.launch_loop_backward)
    out, first = {"rank": rank}, None
    for name, bs in (("qm9", 128), ("mp", 64)):
        cfg = ScannConfig(model=ModelConfig(**spec[f"{name}_model"]),
                          hyper=HyperConfig(batch_size=bs))
        t = Trainer(cfg, dev, os.path.join(spec["work"], f"rank{rank}"), mesh=make_mesh())
        assert t.mesh.world == world and t.mesh.rank == rank and t._sharded_train
        t.load_params(spec[f"{name}_params"])
        out[name], t_first = _run_shard_steps(t, spec[f"{name}_steps"], spec[f"{name}_eval"],
                                              dev)
        first = first or t_first
    out["launches"] = [c.launches for c in counters]
    out["schedules"] = [schedules(kbwd.launch_scann_backward),
                        schedules(kloop.launch_loop_backward)]
    out["first_step_s"] = first - t_spawn
    mesh = make_mesh()
    for name, kind in (("qm9", "scann"), ("mp", "loop")):
        cfm = ModelConfig(**spec[f"{name}_model"])
        leaves = {k: v.to(dev).requires_grad_(True) for k, v in spec[f"{name}_params"].items()}
        apply = getattr(sharded, f"make_sharded_{kind}_apply")(mesh, cfm, False, 0.1)
        pred, ga = apply(leaves, _to_device(spec[f"{name}_eval"], dev), APPLY_SEED)
        ct_pred, ct_ga = (c.to(dev) for c in _apply_cotangents(spec, name))
        grads = torch.autograd.grad((pred * ct_pred).sum() + (ga * ct_ga).sum(),
                                    list(leaves.values()))
        out[f"{name}_apply"] = {"pred": pred.detach().cpu(), "ga": ga.detach().cpu(),
                                "params": {k: g.cpu() for k, g in zip(leaves, grads)}}
    out["stats"] = dict(cache.stats)
    dist.barrier()
    dist.destroy_process_group()
    if cache.stats["compiles"]:
        raise RuntimeError(f"rank {rank} built {cache.stats['compiles']} kernels: no warm start")
    torch.save(out, out_path)
    return 0


def phase13_serve(spec_path, out_path, t_spawn):
    """Phase 13's served request (``python3 chip_smoke.py --phase13-serve
    ...``): a fresh process, with its own build cache on the directory the
    parent filled, serves one QM9 request through
    ``BatchedPredictor(exec_cache=<that directory>)``; it must load its
    kernel from the disk and build nothing."""
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.serve import BatchedPredictor

    spec = torch.load(spec_path, weights_only=True)
    dev = torch.device(spec["device"])
    cfg = ScannConfig(model=ModelConfig(**spec["qm9_model"]),
                      hyper=HyperConfig(batch_size=128, target="homo",
                                        target_mean=-0.24, target_std=0.022))
    scann = Scann(cfg, device=dev, workdir=os.path.join(spec["work"], "serve"))
    scann.trainer.load_params(spec["qm9_params"])
    t1 = time.perf_counter()
    predictor = BatchedPredictor(scann, window_ms=0.0, warmup_shapes=[],
                                 exec_cache=spec["cache_dir"])
    try:
        t2 = time.perf_counter()
        (value, ga), = predictor.predict([Structure(*MOLECULES["water"])])
        t3 = time.perf_counter()
        start_to_answer = time.time() - t_spawn
    finally:
        predictor.close()
    stats = dict(scann.exec_cache.stats)
    torch.save({"predictor_ms": 1e3 * (t2 - t1), "first_request_ms": 1e3 * (t3 - t2),
                "start_to_answer_s": start_to_answer,
                "finite": bool(np.isfinite(value) and np.isfinite(ga).all()),
                "stats": stats}, out_path)
    if stats["compiles"] or (dev.type == "cuda" and not stats["disk_hits"]):
        raise RuntimeError(f"the served first request did not load its kernel from the cache "
                           f"without a build: {stats}")
    return 0


def _spawn(args, env, cwd, timeout):
    """Start ``chip_smoke.py args`` for each entry of ``args`` at once, wait
    for all (each killed after ``timeout`` s); returns (return codes, logs)."""
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen([sys.executable, here, *a], env=env, cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for a in args]
    logs = {}
    try:
        for r, p in enumerate(procs):
            try:
                logs[r], _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                logs[r], _ = p.communicate()
                logs[r] += f"\n(timed out after {timeout} s)"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [p.returncode for p in procs], logs


def _ordered_shards(trainer, world):
    """Make ``trainer`` (one process) run each step and eval batch as
    ``world`` shards one after another in rank order, the gradients added
    from rank 0 up: what the ranks of phase 13 must equal bit for bit."""
    from scann_tpu_torch.parallel import RankLayout
    from scann_tpu_torch.parallel.mesh import batch_sharding

    def shards(batch):
        for r in range(world):
            rows = batch_sharding(RankLayout(world, r, trainer.device), batch["atomic"].shape[0])
            yield rows, {k: v[rows] for k, v in batch.items()}

    def raw_grads(batch, y, seed):
        route = trainer.train_route(batch["atomic"].shape[1], batch["neighbors"].shape[2])
        preds, total = [], None
        for rows, x in shards(batch):
            pred, g = trainer._whole_model_grads(route, x, y[rows], seed, rows.start)
            preds.append(pred)
            total = g if total is None else {k: total[k] + g[k] for k in total}
        return torch.cat(preds), total

    def eval_batch(batch):
        outs = [trainer.forward_eval(trainer.params, x) for _, x in shards(batch)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    trainer.raw_grads, trainer.eval_batch = raw_grads, eval_batch
    return trainer


def phase13(qm9_model, mp2018, qm9_run, cache_dir, failures, card, device="cuda:0"):
    """Two ranks of the Trainer's data parallelism on the one card (each a
    process on cuda:0, over gloo, passed explicitly: NCCL refuses two ranks
    on one device), both loading their kernels from the build cache that
    the forced build filled: 4 QM9 steps at the flagship width (batch 128,
    64 a rank, #2) on phase 5's buckets, 2 MP2018 steps at (64, 96, 32) (32
    a rank, #4), one sharded eval batch of each (#1, #3). Holds them bit for
    bit to one process that runs the same shards in rank order, and within
    1e-4 to the whole-batch run. Returns the ranks' launches, the backward
    kernels' also by schedule (``<kernel>/<schedule>``; ``device`` "cpu"
    rehearses the phase on the kernels' plain versions)."""
    import socket

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.models.scann import init_params
    from scann_tpu_torch.parallel import RankLayout
    from scann_tpu_torch.train.loop import Trainer

    t0 = time.time()
    energy, nbr = qm9_run["data"]
    work = os.path.join(qm9_run["work"], "phase13")
    cfg = ScannConfig(model=qm9_model,
                      hyper=HyperConfig(batch_size=128, data_energy_path=energy,
                                        data_nei_path=nbr, seed=0,
                                        save_path=os.path.join(work, "run")),
                      tpu=TpuConfig(max_buckets=2))
    s = Scann(cfg, device=device)
    s.prepare_dataset()
    qm9_steps = []
    for k in range(4):                       # two steps a bucket, in the epoch plan's order
        b = s.train_buckets[k // 2]
        idx, seeds = s.trainer.epoch_plan(0, k // 2, len(b.targets), 128)
        rows = idx[(k % 2) % len(idx)].numpy()
        qm9_steps.append(({n: torch.from_numpy(np.ascontiguousarray(v[rows]))
                           for n, v in b.inputs.items()},
                          torch.from_numpy(np.asarray(b.targets[rows], np.float32)),
                          5e-4 / (1 + k), seeds[(k % 2) % len(seeds)]))
    rng = np.random.default_rng(13)
    mp_steps = [(synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20),
                 torch.from_numpy(rng.normal(size=64).astype(np.float32)), 5e-4, 21 + k)
                for k in range(2)]
    mp_steps = [({n: v.cpu() for n, v in x.items()}, y, lr, seed) for x, y, lr, seed in mp_steps]
    b0 = s.train_buckets[0]
    spec = {"cache_dir": cache_dir, "work": work, "device": device,
            "qm9_model": _model_dict(qm9_model), "mp_model": _model_dict(mp2018),
            "qm9_params": init_params(qm9_model, torch.Generator().manual_seed(0)),
            "mp_params": init_params(mp2018, torch.Generator().manual_seed(1)),
            "qm9_steps": qm9_steps, "mp_steps": mp_steps,
            "qm9_eval": {n: torch.from_numpy(np.ascontiguousarray(v[np.arange(128)
                                                                    % len(b0.targets)]))
                         for n, v in b0.inputs.items()},
            "mp_eval": {n: v.cpu() for n, v in
                        synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms,
                                        min_atoms=20).items()}}
    os.makedirs(work, exist_ok=True)
    spec_path = os.path.join(work, "spec.pt")
    torch.save(spec, spec_path)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    outs = [os.path.join(work, f"rank{r}.pt") for r in range(2)]
    serve_out = os.path.join(work, "serve.pt")
    cwd = os.path.dirname(os.path.abspath(__file__))
    t_spawn = time.time()
    rcs, logs = _spawn([["--phase13-rank", str(r), "2", f"127.0.0.1:{port}", spec_path,
                         outs[r], repr(t_spawn)] for r in range(2)], env, cwd, 300)
    ranks_s = time.time() - t_spawn
    t_serve = time.time()
    serve_rc, serve_log = _spawn([["--phase13-serve", spec_path, serve_out, repr(t_serve)]],
                                 env, cwd, 300)
    serve_s = time.time() - t_serve
    bad = [(f"rank {r}", rc, logs[r]) for r, rc in enumerate(rcs) if rc != 0]
    bad += [("the serving process", serve_rc[0], serve_log[0])] if serve_rc[0] != 0 else []
    if bad:
        for who, rc, log in bad:
            print(f"phase 13: {who} failed (exit {rc}):\n{log[-6000:]}", flush=True)
        failures.append(f"phase 13: {[who for who, _, _ in bad]} failed")
        return None
    got = [torch.load(o, weights_only=True) for o in outs]
    serve = torch.load(serve_out, weights_only=True)

    # the references in this process: the same shards in rank order, and the
    # whole batch
    ref = {}
    for how in ("ordered", "whole"):
        for name, cfm, bs in (("qm9", qm9_model, 128), ("mp", mp2018, 64)):
            t = Trainer(ScannConfig(model=cfm, hyper=HyperConfig(batch_size=bs)), device,
                        os.path.join(work, how), mesh=RankLayout(1, 0, torch.device(device)))
            if how == "ordered":
                _ordered_shards(t, 2)
            t.load_params(spec[f"{name}_params"])
            ref[how, name], _ = _run_shard_steps(t, spec[f"{name}_steps"], spec[f"{name}_eval"],
                                                 t.device)

    # the two make_sharded_*_apply wrappers: each shard's forward and
    # gradient by the JAX-signature functions, in rank order, summed from rank 0
    from scann_tpu_torch.kernels import sharded
    from scann_tpu_torch.train.loop import _to_device

    for name, cfm, fn in (("qm9", qm9_model, "fused_scann"), ("mp", mp2018, "loop_scann")):
        x = _to_device(spec[f"{name}_eval"], device)
        cts = [c.to(device) for c in _apply_cotangents(spec, name)]
        params = {k: v.to(device) for k, v in spec[f"{name}_params"].items()}
        preds, gas, total = [], [], None
        for r in range(2):
            rows, xr = sharded.local_rows(RankLayout(2, r, torch.device(device)), x)
            p, ga = getattr(sharded, f"{fn}_forward")(params, xr, cfm, False, 0.1, APPLY_SEED,
                                                      mol_base=rows.start)
            g = getattr(sharded, f"{fn}_grad")(params, xr, cfm, cts[0][rows], cts[1][rows], 0.1,
                                               APPLY_SEED, mol_base=rows.start)
            preds.append(p)
            gas.append(ga)
            total = g if total is None else {k: total[k] + g[k] for k in total}
        ref["ordered", f"{name}_apply"] = {"pred": torch.cat(preds).cpu(),
                                           "ga": torch.cat(gas).cpu(),
                                           "params": {k: v.cpu() for k, v in total.items()}}

    def flat(out):
        return {f"{what} {k}": v for what, d in out.items()
                for k, v in list(d.items()) + list(d["params"].items()) if k != "params"}

    kinds = ("qm9", "mp", "qm9_apply", "mp_apply")
    mine, other = flat({n: got[0][n] for n in kinds}), flat({n: got[1][n] for n in kinds})
    ordered = flat({n: ref["ordered", n] for n in kinds})
    whole = flat({n: ref["whole", n] for n in ("qm9", "mp")})
    unequal = [k for k in mine if not (torch.equal(mine[k], ordered[k])
                                       and torch.equal(mine[k], other[k]))]
    n_apply = sum(1 for k in mine if "_apply " in k)
    worst_l = max(float(((mine[k] - whole[k]).abs() / whole[k].abs()).max())
                  for k in whole if k.endswith(" losses"))
    worst_w = max(float((mine[k] - whole[k]).abs().max()) / max(float(whole[k].abs().max()), 1e-30)
                  for k in whole if not k.endswith(" losses"))
    names = ("scann_forward", "scann_backward", "scann_loop", "scann_loop_backward",
             "local_attention")
    launches = {n: [g["launches"][i] for g in got] for i, n in enumerate(names)}
    stash = {n: [g["schedules"][i]["f32"] for g in got] for i, n in enumerate(names[1:4:2])}
    wall = time.time() - t0
    print(f"phase 13: 2 ranks on {device} over gloo, kernels from the build cache "
          f"{os.path.relpath(cache_dir)}: builds {[g['stats']['compiles'] for g in got]}, "
          f"library loads from disk {[g['stats']['disk_hits'] for g in got]}; from process start "
          f"to the first finished step {[round(g['first_step_s'], 3) for g in got]} s; launches "
          f"a rank {launches}, of them with the f32 stash {stash}  [{card}]", flush=True)
    print(f"phase 13: QM9 losses {got[0]['qm9']['losses'].tolist()}, MP2018 losses "
          f"{got[0]['mp']['losses'].tolist()}; {len(mine) - len(unequal)} of {len(mine)} "
          f"tensors (losses, predictions, GA scores, every weight of both models, and the "
          f"outputs and {n_apply - 4} gradients of make_sharded_scann_apply and "
          f"make_sharded_loop_apply) bit-identical to one process running the shards in rank "
          f"order and between the ranks{'' if not unequal else ', unequal: ' + str(unequal)}; "
          f"against the whole batch: weights, predictions and GA scores within "
          f"{worst_w:.3e} x max (limit 1e-4), losses {worst_l:.3e} relative (limit 1e-4)  "
          f"[{card}]", flush=True)
    print(f"phase 13: a fresh process served one QM9 request through "
          f"BatchedPredictor(exec_cache=...): from process start to the answer "
          f"{serve['start_to_answer_s']:.3f} s, predictor ready in {serve['predictor_ms']:.1f} "
          f"ms, first request {serve['first_request_ms']:.1f} ms (its kernel loaded from disk), "
          f"builds {serve['stats']['compiles']}, loads from disk {serve['stats']['disk_hits']}; "
          f"the ranks ran {ranks_s:.1f} s, the serving process {serve_s:.1f} s, the phase "
          f"{wall:.1f} s  [{card}]", flush=True)
    if (unequal or not worst_w <= 1e-4 or not worst_l <= 1e-4
            or any(g["stats"]["compiles"] for g in got) or serve["stats"]["compiles"]
            or (device != "cpu" and not serve["stats"]["disk_hits"]) or not serve["finite"]
            or any(min(launches[n]) < 1 for n in names[:4]) or max(launches["local_attention"])
            or any(min(v) < 1 for v in stash.values())):
        failures.append(f"phase 13: unequal {unequal}, whole-batch {worst_w:.3e} / {worst_l:.3e}, "
                        f"builds {[g['stats']['compiles'] for g in got]} + "
                        f"{serve['stats']['compiles']}, launches {launches}, with the f32 "
                        f"stash {stash}")
    return {**{n: sum(v) for n, v in launches.items()},
            **{f"{n}/{m}": sum(g["schedules"][i][m] for g in got)
               for i, n in enumerate(names[1:4:2]) for m in SCHEDULES}}


# ---- phase 17: wide neighbour lists in #5, #3 and #4 ----------------------------------------

WIDE_ATTN_RTOL = 2.0 ** -7   # #5 on bfloat16 tensors: one bf16 ulp between two roundings


def wide_masks(mask):
    """Masked edges of a wide neighbour list in a [B, M, N] neighbour mask on
    the card: structure 0's atom 0 with every neighbour masked, its atom 1
    with the neighbours past the first 64 masked (N > 64: a wholly masked
    sub-chunk of #3 and #5, one or more of #4) or past the first 32 (N <=
    64: #4's last sub-chunk) and its atom 2 with only the last one live."""
    N = mask.shape[2]
    mask[0, 0] = 0.0
    mask[0, 1, 64 if N > 64 else 32:] = 0.0
    mask[0, 2, : N - 1] = 0.0
    mask[0, 2, N - 1] = 1.0
    return mask


def wide_batch(rng, B, M, N, cfm, min_atoms=20, edges=True):
    """``synthetic_batch`` whose atoms have up to N neighbours (indices may
    repeat, as periodic images do), so that lists longer than a chunk are
    live, with the masked edges of ``wide_masks`` (``edges``)."""
    x = synthetic_batch(rng, B, M, N, use_ring=cfm.use_ring, n_atoms=cfm.n_atoms,
                        min_atoms=min_atoms)
    counts = x["atom_mask"][:, :, 0].sum(1).long().tolist()
    for b, na in enumerate(counts):
        k = torch.from_numpy(rng.integers(N // 2, N + 1, size=na)).cuda()
        live = (torch.arange(N, device=k.device)[None, :] < k[:, None]).float()
        x["neighbors"][b, :na] = torch.from_numpy(
            rng.integers(0, na, size=(na, N)).astype(np.int32)).cuda()
        x["neighbor_mask"][b, :na] = live
        x["neighbor_weight"][b, :na] = torch.from_numpy(
            rng.uniform(0.3, 3.0, size=(na, N)).astype(np.float32)).cuda() * live
        x["neighbor_distance"][b, :na] = torch.from_numpy(
            rng.uniform(0.8, 4.0, size=(na, N)).astype(np.float32)).cuda() * live
    if edges:
        wide_masks(x["neighbor_mask"])
    return x


def hold_wide_layer(tag, args, failures):
    """#5's wide build on one layer's inputs against its plain version, on f32
    tensors (out, geometry, attention at the forward tolerances) and on the
    same values as bfloat16 tensors (within one bf16 ulp of the plain
    version; the f32 kernel's outputs rounded to bf16 alongside), each
    relaunched into NaN-filled outputs, which must come back bit for bit.
    Returns (worst f32 error, worst bf16 error)."""
    from scann_tpu_torch.kernels import local_attention as kla

    g_update = args[-1]
    B, M, D = args[0].shape
    plan = kla.make_plan(B, M, args[1].shape[2], D, args[6], g_update,
                         kla.sm_count(args[0].device))
    tag = f"{tag} (atom block {plan[0]})"
    nan_like = lambda ts: tuple(None if t is None else torch.full_like(t, float("nan"))
                                for t in ts)
    with torch.inference_mode():
        out, geo, attn = kla.fused_local_attention(*args)
        torch.cuda.synchronize()
        out0, geo0, attn0 = kla.reference_local_attention(*args)
        again = kla._launch(*args, outputs=nan_like((out, geo if g_update else None, attn)))
        args16 = layer_cast(args, torch.bfloat16)
        k16 = kla._launch(*args16)
        k32 = kla._launch(*layer_cast(args16, torch.float32))
        p16 = kla.reference_layer_kernel(*args16)
        again16 = kla._launch(*args16, outputs=nan_like(k16))
        torch.cuda.synchronize()
    named = [("out", out, out0, ATOL), ("attn", attn, attn0, ATTN_ATOL)]
    if g_update:
        named.append(("geometry", geo, geo0, ATOL))
    worst, worst16 = hold(tag, named, failures), 0.0
    differ = [w for w, a, b in zip(("out", "geometry", "attn"), again,
                                   (out, geo if g_update else None, attn))
              if a is not None and not torch.equal(a, b)]
    differ += [f"bf16 {w}" for w, a, b in zip(("out", "geometry", "attn"), again16, k16)
               if a is not None and not torch.equal(a, b)]
    if differ:
        failures.append(f"{tag}: a relaunch into NaN-filled outputs differs in {differ}")
    line = [f"{tag} bf16 tensors (relaunches bit-identical: {not differ})"]
    for i, name in enumerate(("out", "geometry", "attn")):
        if k16[i] is None:
            continue
        got, want = k16[i].float(), p16[i].float()
        diff = (got - want).abs()
        ok = bool((diff <= ATOL + WIDE_ATTN_RTOL * want.abs()).all())
        same = torch.equal(k16[i], k32[i].to(torch.bfloat16))
        worst16 = max(worst16, diff.max().item())
        line.append(f"{name} {diff.max().item():.2e} (= the f32 kernel rounded: {same})")
        if not ok or not bool(torch.isfinite(got).all()):
            failures.append(f"{tag} bf16 {name}: max_abs {diff.max().item():.3e} beyond one "
                            f"bf16 ulp of the plain version")
    print("  ".join(line), flush=True)
    return worst, worst16


def phase17_layers(mp2018, failures, card):
    """#5's wide build against its plain version (``hold_wide_layer``: f32
    and bf16 tensors, NaN-filled relaunches): one MP2018 layer at (8, 96,
    96), (8, 64, 128), (4, 32, 256), (8, 96, 72) and the odd N of (2, 73,
    81), SCANN+ and SCANN, at the plan's own atom blocks, then at (8, 96, 96)
    SCANN+ at every atom block of ``kla.WIDE_ATOM_BLOCKS``, each forced
    through the wrapper's plan by the SM count it plans for (the kernel
    plans from the count it is given). Times SCANN+ at (8, 96, 96) and at
    the served crystal's (1, 48, 96) (``b1_*`` keys) in turns with the
    plain version, and on bf16 tensors at (8, 96, 96) in turns with f32.
    Returns (worst abs error, the f32 times, the bf16 row's (worst error,
    (ms, f32 ms), plain ms, FLOP, FP32 FLOP, bytes))."""
    from scann_tpu_torch.kernels import local_attention as kla

    rng = np.random.default_rng(17)
    D, H = mp2018.local_dim, mp2018.num_head
    worst, worst16, timing, layer16 = 0.0, 0.0, None, None
    for g_update in (True, False):
        what = "scann+" if g_update else "scann"
        for B, M, N in ((8, 96, 96), (8, 64, 128), (4, 32, 256), (8, 96, 72), (2, 73, 81)):
            args = layer_inputs(rng, B, M, N, D, H, g_update)
            wide_masks(args[3])
            kla.check_neighbor_range(*kla.index_bounds(args[1]), M)
            errs = hold_wide_layer(f"phase 17 #5 wide {what} B={B} M={M} N={N} D={D}", args,
                                   failures)
            worst, worst16 = max(worst, errs[0]), max(worst16, errs[1])
            if (g_update, B, M, N) == (True, 8, 96, 96):
                forced = args
                timing = time_local_attention(args, card)
                args16 = layer_cast(args, torch.bfloat16)
                args32 = layer_cast(args16, torch.float32)    # the same values in f32
                with torch.inference_mode():
                    t16 = in_turns_ms(lambda: kla._launch(*args32), lambda: kla._launch(*args16),
                                      10, 10)
                    plain16 = cuda_ms(lambda: kla.reference_layer_kernel(*args16), 3)
                nbytes = (tensor_bytes(args16[:4], args16[5].values())
                          + 2 * (args16[0].numel() + B * M * N * H + args16[2].numel()))
                layer16 = [t16, plain16, kla.layer_flops(B, M, N, D, True),
                           kla.layer_fp32_flops(B, M, N, D), nbytes]
    real = kla.sm_count
    try:
        for ab in kla.WIDE_ATOM_BLOCKS:
            n_sm = next(n for n in range(1, 4096)
                        if kla.make_plan(8, 96, 96, D, H, True, n)[0] == ab)
            kla.sm_count = lambda dev, n=n_sm: n
            errs = hold_wide_layer(f"phase 17 #5 wide scann+ B=8 M=96 N=96 D={D} planned for "
                                   f"{n_sm} SMs", forced, failures)
            worst, worst16 = max(worst, errs[0]), max(worst16, errs[1])
    finally:
        kla.sm_count = real
    # the served crystal's shape: one structure of 48 sites at N = 96
    served = time_local_attention(layer_inputs(rng, 1, 48, 96, D, H, True), card)
    timing.update({f"b1_{k}": served[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "measured_bound_ms", "ms_back_to_back")})
    return worst, timing, (worst16, *layer16)


def hold_wide_backward(label, cfm, p, x, y, rate, seed, failures, clusters=(1, 2, 4),
                       relaunches=2):
    """#4's wide build at every cluster size of ``clusters``, in its three
    schedules (``_launch_backward(..., stash=)``): the f32 stash against the
    plain f32 gradients, the recompute schedule bit-equal to it, the bf16
    stash held as phase 16 holds it (``hold_bf16_stash``); ``relaunches``
    further launches of the f32 stash and of recompute on a kept scratch
    filled with NaN, then a constant, bit for bit. Returns the worst abs
    error against the f32 plain version."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    S = kfwd.segment_count(x)
    chunk_atoms, block, _ = kloop.backward_plan(cfm, M, N, S)
    packed = kfwd.pack_params(p, cfm)
    plain32 = kloop.reference_loop_train_grads(p, x, y, cfm, False, rate, seed)
    plain16 = kloop.reference_loop_stash_train_grads(p, x, y, cfm, False, rate, seed,
                                                      mode="bf16")
    worst = 0.0
    for C in clusters:
        tag = (f"{label} B={B} M={M} N={N}{packed_label(x)} (atom block {block}, {C} blocks "
               f"per structure) dropout {rate}")
        got, differ = {}, set()
        for mode in ("f32", None, "bf16"):
            scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, C, mode, S)
            for i in range(1 + (relaunches if mode != "bf16" else 0)):
                if i:
                    for t in scratch.values():
                        if t is not None:
                            t.fill_(float("nan") if i % 2 else -3.0)
                flat, pred = kloop._launch_backward(packed, x, cfm, y, None, True, False, rate,
                                                    seed, 0, scratch, C, stash=mode)
                g = (pred.view(B, -1), kbwd.grads_from_flat(flat, packed, cfm))
                if i == 0:
                    got[mode] = g
                else:
                    differ |= {f"{mode} {k}" for k in g[1] if not torch.equal(g[1][k],
                                                                              got[mode][1][k])}
                    if not torch.equal(g[0], got[mode][0]):
                        differ.add(f"{mode} pred")
            del scratch
        torch.cuda.synchronize()
        line = [tag]
        worst = max(worst, hold_backward(tag, "f32 stash", *got["f32"][:1], plain32[0],
                                         got["f32"][1], plain32[1], line, failures))
        same = (torch.equal(got["f32"][0], got[None][0])
                and all(torch.equal(got["f32"][1][k], got[None][1][k]) for k in got["f32"][1]))
        line.append(f"recompute bit-equal to the f32 stash: {same}; {relaunches} relaunches of "
                    f"each on NaN- and constant-filled scratch bit-identical: {not differ}")
        print("  ".join(line), flush=True)
        if not same:
            failures.append(f"{tag}: the recompute schedule differs from the f32 stash")
        if differ:
            failures.append(f"{tag}: launches on the same inputs differ in {sorted(differ)}")
        hold_bf16_stash(f"{tag} bf16 stash", got["bf16"], plain16, plain32, got[None], failures)
    return worst


def phase17_loops(mp2018, ptgp, failures, card):
    """#3's and #4's wide builds against their plain versions at MP2018 (80,
    96), (60, 128) and (96, 72), Pt/graphene (120, 96) and a packed wide slot
    (MP2018-like crystals at capacity 96, N = 96), and #4's alone at MP2018
    (64, 48) and (96, 40), where #3 runs narrow and one 64-row sub-chunk
    holds an atom's list, past #4's old edge at (300, 48) and at (40, 256),
    where its atom blocks fall to 8 and #3's keys leave shared memory, and
    #3 alone past its old edge at (300, 96) and at the odd N of (73, 81) and
    (30, 199) (B = 2); #4 at 1, 2 and 4 blocks a
    structure, #3 at its own choice and one size of ``HOLD_CLUSTERS`` a
    shape (``held_sizes``: every size over the phase), each with NaN- and
    constant-filled relaunches; #4 in its three schedules at dropout 0.1
    with attention dropout. The holds run at B = 8 (4 at N = 40, 48 and 72,
    2 at the last three; the plain versions' time bounds the phase's), the
    times at B = 16, MP2018 (16, 80, 96), in turns with the plain versions,
    #3 alone also at B = 1 and the recipe batch of 64 (``b1_*`` and
    ``recipe_*`` of its row, at its own cluster sizes), #4's alone at the
    recipe batch (C = 2, recompute: ``recipe_ms`` of its row). Returns
    (worst #3 error, worst #4 error, #3 timing, #4 timing)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(170)
    mp_drop = dataclasses.replace(mp2018, use_drop=True)
    ptgp_drop = dataclasses.replace(ptgp, use_drop=True)
    cases = (("MP2018", mp_drop, wide_batch(rng, 8, 80, 96, mp2018)),
             ("MP2018", mp_drop, wide_batch(rng, 8, 60, 128, mp2018)),
             ("Pt/graphene", ptgp_drop, wide_batch(rng, 8, 120, 96, ptgp)),
             ("MP2018 packed", mp_drop, pack_batch(wide_batch(rng, 12, 48, 96, mp2018), 96)),
             ("MP2018", mp_drop, wide_batch(rng, 4, 64, 48, mp2018)),
             ("MP2018", mp_drop, wide_batch(rng, 4, 96, 40, mp2018)),
             ("MP2018", mp_drop, wide_batch(rng, 4, 96, 72, mp2018)),
             # past the wide #4's old edge (243 atoms at N = 48 with the resident
             # buffer), and at N = 256, where its atom blocks fall to 8
             ("MP2018", mp_drop, wide_batch(rng, 2, 300, 48, mp2018, min_atoms=250)),
             ("MP2018", mp_drop, wide_batch(rng, 2, 40, 256, mp2018)))
    worst3 = worst4 = 0.0
    # #3's wide holds: those of the wide cases, then three more below, over
    # HOLD_CLUSTERS by held_sizes
    n3 = sum(kloop.is_wide_forward(cfm, x["neighbors"].shape[2]) for _, cfm, x in cases) + 3
    held = iter(range(n3))
    for name, cfm, x in cases:
        t0 = time.time()
        p = init_params(cfm, torch.Generator().manual_seed(17), "cuda")
        B = x["atom_mask"].shape[0]
        S = max(kfwd.segment_count(x), 1)
        y = torch.from_numpy(rng.normal(size=(B, S)).astype(np.float32)).cuda()
        if kloop.is_wide_forward(cfm, x["neighbors"].shape[2]):
            worst3 = max(worst3, hold_loop_forward(f"phase 17 #3 wide {name}", cfm, p, x,
                                                   failures, clusters=held_sizes(next(held), n3),
                                                   relaunches=2))
        worst4 = max(worst4, hold_wide_backward(f"phase 17 #4 wide {name}", cfm, p, x, y, 0.1,
                                                7, failures))
        print(f"phase 17 holds at {name} {tuple(x['neighbor_mask'].shape)}: "
              f"{time.time() - t0:.1f} s", flush=True)
    # #3 alone past its old edge (M = 235 at N = 96, the resident centers)
    p = init_params(mp_drop, torch.Generator().manual_seed(17), "cuda")
    x = wide_batch(rng, 2, 300, 96, mp2018, min_atoms=250)
    worst3 = max(worst3, hold_loop_forward("phase 17 #3 wide MP2018", mp_drop, p, x, failures,
                                           clusters=held_sizes(next(held), n3), relaunches=2))
    # odd N: the index ring [2][N] is rounded up so the atom's keys in shared
    # memory stay 16-byte aligned (N = 199: the last N whose keys fit there)
    for M, N in ((73, 81), (30, 199)):
        x = wide_batch(rng, 2, M, N, mp2018)
        worst3 = max(worst3, hold_loop_forward("phase 17 #3 wide MP2018 odd N", mp_drop, p, x,
                                               failures, clusters=held_sizes(next(held), n3),
                                               relaunches=2))
    x = wide_batch(rng, 16, 80, 96, mp2018)
    fwd = next(iter(time_loop_forward("MP2018 wide", mp2018, x, card).values()))
    t4 = time_loop_schedules("wide", "MP2018", mp2018, x, card)
    del x
    fwd.update(time_forward_batches("MP2018 wide", mp2018,
                                    lambda B: wide_batch(rng, B, 80, 96, mp2018), card))
    t4.update(time_recipe_batch("wide", "MP2018", mp2018, wide_batch(rng, 64, 80, 96, mp2018),
                                card))
    return worst3, worst4, fwd, t4


def time_loop_schedules(build, name, cfm, x, card, reps=(3, 8)):
    """#4 at one batch shape in the f32 stash and in the recompute schedule
    (dropout 0.1, one-shot), each in turns with its plain version (plain,
    kernel, kernel, plain; ``reps``: timed calls of each a round), against
    its bound; ``build`` names the build in the printed lines. Returns the
    f32 stash's times with the recompute schedule's beside them."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    params = init_params(cfm, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(params, cfm)
    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    y = torch.from_numpy(np.random.default_rng(B).normal(size=(B, 1)).astype(np.float32)).cuda()
    bwd = {}
    for mode in ("f32", None):
        scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, stash=mode)
        ms, plain_ms = in_turns_ms(
            lambda: kloop.reference_loop_train_grads(params, x, y, cfm, False, 0.1, 7),
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch, stash=mode), *reps)
        del scratch
        flops = kloop.loop_backward_flops(cfm, B, M, N)
        _, P = kbwd.grad_layout(packed)
        nbytes = tensor_bytes(x.values(), weights(packed)) + 4 * B + 4 * (P + B)
        bound, by, measured = bound_ms(flops, nbytes, kbwd.backward_fp32_flops(cfm, B, M, N))
        print(f"scann_loop_backward ({build}) at {name} B={B} M={M} N={N} L={cfm.n_attention} "
              f"({'the f32 stash' if mode else 'the recompute schedule'}; dropout 0.1, one-shot; "
              f"timed in turns: plain, kernel, kernel, plain): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, {flops:.4e} FLOP, bound {bound:.4f} ms by {by} "
              f"({100 * bound / ms:.1f}% of it reached)  [{card}]", flush=True)
        bwd[mode or "recompute"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                    "bound_by": by, "measured_bound_ms": measured,
                                    "flops": flops}
    return dict(bwd["f32"], schedule="f32", recompute_ms=bwd["recompute"]["ms"],
                recompute_plain_ms=bwd["recompute"]["plain_ms"])


def phase17_paths(mp2018, failures, card):
    """The main paths at wide N, through the entry points a user calls, with
    the launch counts set to 0 just before: ``Scann.predict_featurized`` of a
    crystal whose ladder N is 96 and of one of 300 sites (ladder (384, 96),
    past the wide #3's old edge of M = 235), both through #3's wide build,
    and of a crystal to an MP2018 model without the attention LayerNorm,
    which no whole-model kernel takes (the per-layer model through #5's wide
    build), each held to the eager model; then ``Trainer.fit`` for 2 epochs
    of a synthetic MP2018 model in a (64, 48) and a (48, 96) bucket, whose
    steps must all take the "loop" route (#4's wide build in both) with
    finite losses. Returns the launches of #3, #4 and #5 (wide) on these
    paths."""
    import dataclasses
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.pipeline import PackedBucket
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import scann_forward
    from scann_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(171)
    work = tempfile.mkdtemp(prefix="scann_chip_smoke_wide_")
    cfg = ScannConfig(model=mp2018,
                      hyper=HyperConfig(batch_size=16, scheduler="sgdr", lr=5e-4, min_lr=1e-4,
                                        epochs=2, seed=0, save_path=os.path.join(work, "run")),
                      tpu=TpuConfig(max_buckets=2))
    scann = Scann(cfg, device="cuda")
    scann.init_params(0)

    def record(na, nmax):
        x = wide_batch(rng, 1, na, nmax, mp2018, min_atoms=na, edges=False)
        return {k: v.cpu().numpy() for k, v in x.items()}

    structs = [Structure(["Si"] * na, rng.uniform(0, 9, size=(na, 3)), np.eye(3) * 9.0)
               for na in (40, 300)]
    inputs = [record(40, 80), record(300, 80)]
    counters = (kloop.launch_loop_forward, kla.fused_local_attention, kfwd.fused_scann_forward)
    for c in counters:
        c.launches = c.wide_launches = 0
    answers = scann.predict_featurized(structs, inputs, batch_size=4)
    torch.cuda.synchronize()
    loop_wide, layer_wide = (kloop.launch_loop_forward.wide_launches,
                             kla.fused_local_attention.wide_launches)
    routes = [scann.trainer.eval_route(48, 96), scann.trainer.eval_route(384, 96)]
    # the same crystal of 40 sites to a model without the attention
    # LayerNorm: the per-layer model, #5's wide build on each layer
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(mp2018, use_attn_norm=False))
    layered = Scann(plain_cfg, device="cuda")
    layered.init_params(0)
    answers += layered.predict_featurized(structs[:1], inputs[:1], batch_size=4)
    torch.cuda.synchronize()
    loop_wide = kloop.launch_loop_forward.wide_launches
    layer_wide = kla.fused_local_attention.wide_launches
    routes.append(layered.trainer.eval_route(48, 96))
    print(f"phase 17 served: a crystal of 40 sites, 80 neighbours (ladder (48, 96), route "
          f"{routes[0]}), one of 300 sites (ladder (384, 96), route {routes[1]}) and the first "
          f"to a model without the attention LayerNorm (route {routes[2]}): wide launches #3 "
          f"{loop_wide}, #5 {layer_wide}, #1 {kfwd.fused_scann_forward.launches}", flush=True)
    if (routes != ["loop", "loop", "per_layer"]
            or (loop_wide, layer_wide) != (2, mp2018.n_attention)):
        failures.append(f"phase 17 served: routes {routes}, wide launches #3 {loop_wide}, #5 "
                        f"{layer_wide}; want 2 and {mp2018.n_attention}")
    for (pred, ga), x, s, who in zip(answers, inputs + inputs[:1], structs + structs[:1],
                                     (scann, scann, layered)):
        with torch.inference_mode():
            want, _ = scann_forward(who.params, {k: torch.from_numpy(v).cuda()
                                                 for k, v in x.items()}, who.config.model)
        hyper = who.config.hyper
        want = want[0, 0].item() * hyper.target_std + hyper.target_mean
        if not (abs(pred - want) <= ATOL + RTOL * abs(want)) or len(ga) != len(s):
            failures.append(f"phase 17 served {len(s)} sites: {pred} against the eager "
                            f"model's {want}")
    print(f"phase 17 served answers {[round(a[0], 6) for a in answers]} held to the eager "
          f"model at rtol {RTOL} atol {ATOL}", flush=True)
    hyper = cfg.hyper

    def bucket(n, M, N):
        x = {k: v.cpu().numpy() for k, v in wide_batch(rng, n, M, N, mp2018).items()}
        return PackedBucket(x, rng.normal(size=n).astype(np.float32), np.arange(n))

    train = [bucket(32, 64, 48), bucket(32, 48, 96)]
    valid = [bucket(16, 64, 48), bucket(16, 48, 96)]
    trainer = Trainer(cfg, device="cuda", workdir=os.path.join(work, "fit"))
    routes = [trainer.train_route(*b.shape) for b in train]
    kbwd.reset_counts(kloop.launch_loop_backward)
    kbwd.reset_counts(kbwd.launch_scann_backward)
    for c in counters:
        c.launches = c.wide_launches = 0
    t0 = time.time()
    hist = trainer.fit(train, valid, epochs=2, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    wall = time.time() - t0
    steps = 2 * sum(-(-b.num_structures // hyper.batch_size) for b in train)
    wide_steps = 2 * sum(-(-b.num_structures // hyper.batch_size) for b in train
                         if kloop.is_wide_backward(cfg.model, b.shape[1]))
    c4 = kloop.launch_loop_backward
    print(f"phase 17 trained 2 epochs in buckets {[b.shape for b in train]} (routes {routes}) "
          f"in {wall:.1f} s: {steps} steps, #4 launches {c4.launches} ({c4.wide_launches} "
          f"wide; {mode_counts(c4)}), #2 {kbwd.launch_scann_backward.launches}; losses "
          f"{[round(v, 5) for v in hist['loss']]}  [{card}]", flush=True)
    if (routes != ["loop", "loop"] or c4.launches != steps or c4.wide_launches != wide_steps
            or kbwd.launch_scann_backward.launches):
        failures.append(f"phase 17 training: routes {routes}, #4 launches {c4.launches} "
                        f"({c4.wide_launches} wide) for {steps} steps ({wide_steps} wide)")
    if not all(np.isfinite(hist["loss"])):
        failures.append(f"phase 17 training: losses {hist['loss']}")
    return {"scann_loop_wide": loop_wide, "scann_loop_backward_wide": c4.wide_launches,
            "local_attention_wide": layer_wide}


def phase17(mp2018, ptgp, failures, card):
    """Phase 17: wide neighbour lists. Returns the kernels line's rows of the
    three wide builds, and the holds and times of #5's wide build on bf16
    tensors for phase 19's row."""
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_loop as kloop

    t0 = time.time()
    err5, t5, layer16 = phase17_layers(mp2018, failures, card)
    t1 = time.time()
    err3, err4, t3, t4 = phase17_loops(mp2018, ptgp, failures, card)
    t2 = time.time()
    launches = phase17_paths(mp2018, failures, card)
    print(f"phase 17 wall (s): #5 {t1 - t0:.1f}, #3 and #4 {t2 - t1:.1f}, main paths "
          f"{time.time() - t2:.1f}", flush=True)
    rows = []
    for name, source, replaces, err, t in (
            ("scann_loop_wide", "scann_tpu_torch/csrc/scann_loop_wide.cu", kloop.REPLACES,
             err3, t3),
            ("scann_loop_backward_wide", "scann_tpu_torch/csrc/scann_loop_backward_wide.cu",
             kloop.BACKWARD_REPLACES, err4, t4),
            ("local_attention_wide", "scann_tpu_torch/csrc/local_attention_wide.cu",
             kla.REPLACES, err5, t5)):
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launches[name], "max_abs_err": err, "library_ms": None,
                     **{k: v for k, v in t.items() if k != "cluster"}})
    return rows, layer16



# ---- phase 18: tall structures in #3 and #4 (the centers read from L2) ----------------------

def tall_against_narrow(label, cfm, x, failures):
    """The tall builds forced (``tall=True``) at a shape the narrow builds
    take, against the narrow builds at 1, 2 and 4 blocks a structure: #3 at
    dropout 0.1 bit for bit (the same atom blocks; only where the rows live
    differs); #4 (one-shot, dropout 0.1) in its three schedules, whose
    64-row chunks and atom blocks of 16 sum the weight gradients and the
    d(layer input) partials in another order than the narrow build. At f32
    operands the two builds within #4's gradient limit, GRAD_RTOL x max, of
    each other, and each against its plain version: the f32 stash and
    recompute within GRAD_RTOL x max, the bf16 stash as phase 16 holds it
    (``hold_bf16_stash``). At bf16 operands, where an f32 sum order flips
    bf16 roundings (phase 14), each build's recompute and bf16 stash against
    its bf16 plain version with phase 19's full-depth criteria
    (``hold_bf16_grads``, 0.9 x the f32 kernel's reading), the f32 stash
    bit-equal to recompute, and the two builds' mean distance within
    BF16_FLOOR x the f32-noise floor of the plain version. Returns the
    worst distance of the two builds: at f32 as a share of max |narrow|, at
    bf16 as a share of BF16_FLOOR x the floor."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    params = init_params(cfm, torch.Generator().manual_seed(18), "cuda")
    packed = kfwd.pack_params(params, cfm)
    y = torch.from_numpy(np.random.default_rng(18).normal(size=(B, 1)).astype(np.float32)).cuda()
    f32 = cfm.dtype != "bfloat16"
    cfm32 = dataclasses.replace(cfm, dtype="float32")
    run = lambda q, c: kloop.reference_loop_train_grads(q, x, y, c, False, 0.1, 7)
    stash = lambda q: kloop.reference_loop_stash_train_grads(q, x, y, cfm, False, 0.1, 7,
                                                             mode="bf16")
    plain32, plain_st = run(params, cfm32), stash(params)
    flat = lambda g: torch.cat([g[k].double().reshape(-1) for k in sorted(g)])
    dist = lambda u, v: (u - v).abs().mean().item()
    if not f32:
        plain16 = run(params, cfm)
        floors = [run(f64_params(params), cfm)] + [run(jittered(params, j), cfm)
                                                   for j in range(JITTERS)]
        st_floors = [stash(f64_params(params))] + [stash(jittered(params, j))
                                                   for j in range(JITTERS)]
        floor = {m: max(dist(flat(want[1]), flat(f[1])) for f in fl)
                 for m, want, fl in ((None, plain16, floors), ("bf16", plain_st, st_floors))}
        floor["f32"] = floor[None]
    differ, worst, before = [], 0.0, (kloop.launch_loop_forward.tall_launches,
                                      kloop.launch_loop_backward.tall_launches)
    for C in (1, 2, 4):
        with torch.inference_mode():
            narrow = kloop._launch(packed, x, cfm, False, 0.1, 11, 0, C)
            tall = kloop._launch(packed, x, cfm, False, 0.1, 11, 0, C, tall=True)
        differ += [f"#3 C={C} {w}" for w, a, b in zip(("pred", "ga"), narrow, tall)
                   if not torch.equal(a, b)]
        got = {}
        for mode in ("f32", None, "bf16"):
            # the gradients by name (the flat vector's alignment gaps are not written)
            got[mode] = [(pred.view(B, -1), kbwd.grads_from_flat(flat_g, packed, cfm))
                         for flat_g, pred in (
                kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0, None,
                                       C, stash=mode, tall=t) for t in (False, True))]
            (p0, g0), (p1, g1) = got[mode]
            if f32:
                rel, key, _ = grad_errors(g1, g0)
            else:
                rel, key = dist(flat(g1), flat(g0)) / (BF16_FLOOR * floor[mode]), "the mean"
            worst = max(worst, rel)
            if not ((rel <= GRAD_RTOL if f32 else rel <= 1.0) and errors(p1, p0)[2]
                    and all(bool(torch.isfinite(v).all()) for v in g1.values())):
                differ.append(f"#4 C={C} stash {mode}: {rel:.3e} at {key}")
        tag = f"{label} B={B} M={M} N={N} C={C} #4"
        if f32:
            line = [f"{tag} against its plain version"]
            for build, i in (("narrow", 0), ("tall", 1)):
                for mode in ("f32", None):
                    hold_backward(tag, f"{build} {mode or 'recompute'}", *got[mode][i][:1],
                                  plain32[0], got[mode][i][1], plain32[1], line, failures)
                hold_bf16_stash(f"{tag}, {build} bf16 stash", got["bf16"][i], plain_st, plain32,
                                got[None][i], failures)
            print("  ".join(line), flush=True)
            continue
        got32 = kloop._launch_backward(packed, x, cfm32, y, None, True, False, 0.1, 7, 0, None,
                                       C, stash=None)
        got32 = (got32[1].view(B, -1), kbwd.grads_from_flat(got32[0], packed, cfm32))
        for build, i in (("narrow", 0), ("tall", 1)):
            hold_bf16_grads(f"{tag} {build} recompute", got[None][i], plain16, plain32, floors,
                            got32, failures, 0.9)
            hold_bf16_grads(f"{tag} {build} bf16 stash", got["bf16"][i], plain_st, plain32,
                            st_floors, got32, failures, 0.9)
            if not all(torch.equal(a, b) for a, b in zip(
                    [got["f32"][i][0], *got["f32"][i][1].values()],
                    [got[None][i][0], *got[None][i][1].values()])):
                failures.append(f"{tag} {build}: the f32 stash differs from recompute")
    torch.cuda.synchronize()
    ran = (kloop.launch_loop_forward.tall_launches - before[0],
           kloop.launch_loop_backward.tall_launches - before[1])
    blocks = (kloop.forward_plan(cfm, M, N)[1], kloop.backward_plan(cfm, M, N)[1],
              kloop.backward_plan(cfm, M, N, tall=True)[:2])
    limit = (f"within {worst:.3e} x max of each other, limit {GRAD_RTOL}" if f32 else
             f"mean distance {worst:.3f} x the limit, {BF16_FLOOR} x the f32-noise floor")
    print(f"{label} B={B} M={M} N={N}: tall=True against the narrow build at C = 1, 2, 4 (#3 "
          f"at dropout 0.1, atom blocks {blocks[0]}: bit-identical "
          f"{not any(d.startswith('#3') for d in differ)}; #4 in its three schedules, narrow "
          f"atom block {blocks[1]}, tall (chunk atoms, block) {blocks[2]}: {limit}; {ran} tall "
          f"launches)", flush=True)
    if differ or ran != (3, 9):
        failures.append(f"{label}: the tall build differs from the narrow one in {differ} "
                        f"({ran} tall launches)")
    return worst


def phase18_holds(mp2018, ptgp, failures):
    """#3's and #4's tall builds against their plain versions at the TPU
    gates' edges, full width, B = 2: Pt/graphene (322, 32) and (573, 16),
    MP2018 (428, 16), and MP2018-like crystals packed at capacity 300 (N =
    32, up to 8 segments a slot); #4 at 1, 2 and 4 blocks a structure, #3
    at its own choice and the sizes of ``HOLD_CLUSTERS`` that ``held_sizes``
    gives each shape (every size over the four), with NaN- and
    constant-filled relaunches; #4 in its three schedules at
    dropout 0.1 with attention dropout (``hold_wide_backward``: the f32
    stash bit-equal to recompute). Then ``tall=True`` against the narrow
    builds at MP2018 (4, 96, 32) and Pt/graphene (4, 128, 32)
    (``tall_against_narrow``). Returns (worst #3 error, worst #4 error)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(18)
    mp_drop = dataclasses.replace(mp2018, use_drop=True)
    pt_drop = dataclasses.replace(ptgp, use_drop=True)
    pt = dict(use_ring=True, n_atoms=ptgp.n_atoms)
    cases = (("Pt/graphene", pt_drop, synthetic_batch(rng, 2, 322, 32, min_atoms=300, **pt)),
             ("Pt/graphene", pt_drop, synthetic_batch(rng, 2, 573, 16, min_atoms=540, **pt)),
             ("MP2018", mp_drop, synthetic_batch(rng, 2, 428, 16, n_atoms=mp2018.n_atoms,
                                                 min_atoms=400)),
             ("MP2018 packed", mp_drop, pack_batch(synthetic_batch(
                 rng, 10, 100, 32, n_atoms=mp2018.n_atoms, min_atoms=60), 300)))
    worst3 = worst4 = 0.0
    for i, (name, cfm, x) in enumerate(cases):
        t0 = time.time()
        B, M = x["atom_mask"].shape[:2]
        N, S = x["neighbors"].shape[2], kfwd.segment_count(x)
        if not (kloop.is_tall(cfm, M, N, S) and kloop.is_tall_backward(cfm, M, N, S)):
            raise AssertionError(f"phase 18: {name} {(B, M, N, S)} is not a tall shape")
        p = init_params(cfm, torch.Generator().manual_seed(18), "cuda")
        y = torch.from_numpy(rng.normal(size=(B, max(S, 1))).astype(np.float32)).cuda()
        worst3 = max(worst3, hold_loop_forward(f"phase 18 #3 tall {name}", cfm, p, x, failures,
                                               rate=0.1, clusters=held_sizes(i, len(cases)),
                                               relaunches=2))
        worst4 = max(worst4, hold_wide_backward(f"phase 18 #4 tall {name}", cfm, p, x, y, 0.1,
                                                7, failures))
        print(f"phase 18 holds at {name} {tuple(x['neighbor_mask'].shape)}: "
              f"{time.time() - t0:.1f} s", flush=True)
    tall_against_narrow("phase 18 MP2018", mp2018,
                        synthetic_batch(rng, 4, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20),
                        failures)
    tall_against_narrow("phase 18 Pt/graphene", ptgp,
                        synthetic_batch(rng, 4, 128, 32, min_atoms=20, **pt), failures)
    return worst3, worst4


def phase18_times(mp2018, ptgp, card):
    """#3's and #4's tall builds at the Pt/graphene batch of 16 at (322,
    32), in turns with their plain versions (#4 in the f32 stash and the
    recompute schedule), #3 alone also at B = 1 and the recipe batch of 64
    (``time_forward_batches``), and #4's alone at the recipe batch of 64
    there (C = 2, recompute: ``recipe_ms`` of its row); then each tall build
    against its narrow build at MP2018 (64, 96, 32) in turns (narrow, tall,
    tall, narrow; #4 in the schedule the shape takes, the f32 stash).
    Returns (#3 timing, #4 timing), the latter two with the
    tall-against-narrow times."""
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(181)
    x = synthetic_batch(rng, 16, 322, 32, use_ring=True, n_atoms=ptgp.n_atoms, min_atoms=240)
    t3 = next(iter(time_loop_forward("Pt/graphene tall", ptgp, x, card).values()))
    t4 = time_loop_schedules("tall", "Pt/graphene", ptgp, x, card)
    t3.update(time_forward_batches(
        "Pt/graphene tall", ptgp, lambda B: synthetic_batch(
            rng, B, 322, 32, use_ring=True, n_atoms=ptgp.n_atoms, min_atoms=240), card))
    # the recipe batch of 64 at that M: 2 blocks a structure, in the schedule
    # its f32 stash's size gives (recompute)
    x = synthetic_batch(rng, 64, 322, 32, use_ring=True, n_atoms=ptgp.n_atoms, min_atoms=240)
    t4.update(time_recipe_batch("tall", "Pt/graphene", ptgp, x, card))
    del x
    x = synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20)
    B, M, N = 64, 96, 32
    packed = kfwd.pack_params(init_params(mp2018, torch.Generator().manual_seed(0), "cuda"),
                              mp2018)
    y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
    with torch.inference_mode():
        scratch = [kloop.loop_forward_scratch(mp2018, B, M, N, "cuda", tall=t)
                   for t in (False, True)]
        fwd = in_turns_ms(lambda: kloop._launch(packed, x, mp2018, False, 0.0, 0, 0, None,
                                                scratch[0]),
                          lambda: kloop._launch(packed, x, mp2018, False, 0.0, 0, 0, None,
                                                scratch[1], tall=True), 10, 10)
    del scratch
    mode = kloop.loop_stash_mode(mp2018, B, M, N)
    scratch = [kloop.loop_backward_scratch(packed, mp2018, B, M, N, stash=mode, tall=t)
               for t in (False, True)]
    bwd = in_turns_ms(lambda: kloop._launch_backward(packed, x, mp2018, y, None, True, False,
                                                     0.1, 7, 0, scratch[0]),
                      lambda: kloop._launch_backward(packed, x, mp2018, y, None, True, False,
                                                     0.1, 7, 0, scratch[1], tall=True), 5, 5)
    del scratch
    C = kloop.cluster_size(B)
    for what, (tall_ms, narrow_ms), t in (("scann_loop", fwd, t3),
                                          (f"scann_loop_backward ({mode} stash)", bwd, t4)):
        print(f"{what} at MP2018 B={B} M={M} N={N}, C={C} (timed in turns: narrow, tall, tall, "
              f"narrow): tall build {tall_ms:.4f} ms, narrow build {narrow_ms:.4f} ms "
              f"({100 * (tall_ms / narrow_ms - 1):+.1f}%)  [{card}]", flush=True)
        t.update(tall_ms_mp2018=tall_ms, narrow_ms_mp2018=narrow_ms)
    return t3, t4


def time_recipe_batch(build, name, cfm, x, card):
    """#4 alone at a recipe batch ``x`` (B = 64: 2 blocks a structure), in
    the schedule its f32 stash's size gives (dropout 0.1, one-shot), 5 timed
    launches after 3, against its bound; ``build`` names the build in the
    printed line. Returns the ``recipe_*`` keys of a kernels-line row."""
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cuda"), cfm)
    y = torch.from_numpy(np.random.default_rng(B).normal(size=(B, 1)).astype(np.float32)).cuda()
    mode = kloop.loop_stash_mode(cfm, B, M, N)
    scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, stash=mode)
    ms = cuda_ms(lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                                scratch, stash=mode), 5)
    del scratch
    _, P = kbwd.grad_layout(packed)
    flops = kloop.loop_backward_flops(cfm, B, M, N)
    bound, by, measured = bound_ms(flops, tensor_bytes(x.values(), weights(packed)) + 4 * B
                                   + 4 * (P + B), kbwd.backward_fp32_flops(cfm, B, M, N))
    print(f"scann_loop_backward ({build}) at {name} B={B} M={M} N={N} L={cfm.n_attention}, "
          f"C={kloop.cluster_size(B)} (the {mode or 'recompute'} schedule; dropout 0.1, "
          f"one-shot): kernel {ms:.4f} ms, {flops:.4e} FLOP, bound {bound:.4f} ms by {by} "
          f"({100 * bound / ms:.1f}% of it reached)  [{card}]", flush=True)
    return {"recipe_ms": ms, "recipe_bound_ms": bound, "recipe_measured_bound_ms": measured,
            "recipe_schedule": mode or "recompute"}


def phase18_paths(mp2018, failures, card):
    """The main paths at tall M, through the entry points a user calls, with
    the launch counts set to 0 just before: ``Scann.predict_featurized`` of
    a 300-site crystal with up to 24 neighbours (ladder (384, 24): #3's tall
    build, no #5 launch), held to the eager model; then ``Scann.train`` for
    2 epochs of an MP2018 model at the recipes' learning rate on 120
    synthetic periodic crystals of 240-300 sites (the data phase 10 trains
    on: featurized on the host, a target that is a function of the
    structure) in one bucket padded to 32 neighbours, whose steps must all
    take the "loop" route (#4's tall build, one launch a step), with finite
    epoch losses, the last lower than the first, and the bucket's loss
    without dropout lower after training than before (the first epoch's
    6 Adam steps from random weights overshoot: the loss falls from the
    second). The Trainer's first step (B = 16 at its cluster size, on the
    scratch it keeps for the fit) is held to the plain version on the same
    batch first, and the same epochs with the plain step
    (``plain_loop_trainer``) must give the same losses. Returns the
    launches of #3 and #4 (tall) on these paths and the dataset's two files
    (phase 19 trains on them again in bf16)."""
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.data.synthetic import make_synthetic_dataset
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import scann_forward

    rng = np.random.default_rng(182)
    work = tempfile.mkdtemp(prefix="scann_chip_smoke_tall_")
    cfg = ScannConfig(model=mp2018,
                      hyper=HyperConfig(batch_size=16, scheduler="sgdr", lr=5e-4, min_lr=1e-4,
                                        epochs=1, seed=0, save_path=os.path.join(work, "run")),
                      tpu=TpuConfig(max_buckets=1))
    scann = Scann(cfg, device="cuda")
    scann.init_params(0)
    x = wide_batch(rng, 1, 300, 24, mp2018, min_atoms=300, edges=False)
    inputs = [{k: v.cpu().numpy() for k, v in x.items()}]
    structs = [Structure(["Si"] * 300, rng.uniform(0, 15, size=(300, 3)), np.eye(3) * 15.0)]
    f3, f5 = kloop.launch_loop_forward, kla.fused_local_attention
    f3.launches = f3.tall_launches = f5.launches = 0
    answers = scann.predict_featurized(structs, inputs, batch_size=4)
    torch.cuda.synchronize()
    served = (f3.launches, f3.tall_launches, f5.launches)
    (pred, ga), = answers
    with torch.inference_mode():
        want, _ = scann_forward(scann.params, {k: torch.from_numpy(v).cuda()
                                               for k, v in inputs[0].items()}, mp2018)
    want = want[0, 0].item() * cfg.hyper.target_std + cfg.hyper.target_mean
    print(f"phase 18 served a crystal of 300 sites, 24 neighbours (ladder (384, 24), route "
          f"{scann.trainer.eval_route(384, 24)}): #3 launches {served[0]} ({served[1]} tall), "
          f"#5 {served[2]}; {pred:.6f} against the eager model's {want:.6f}", flush=True)
    if served != (1, 1, 0):
        failures.append(f"phase 18 served: #3 launches {served[0]} ({served[1]} tall), #5 "
                        f"{served[2]}; want 1, 1 and 0")
    if not (abs(pred - want) <= ATOL + RTOL * abs(want)) or len(ga) != 300:
        failures.append(f"phase 18 served 300 sites: {pred} against the eager model's {want}")

    t0 = time.time()
    energy, nbr = make_synthetic_dataset(os.path.join(work, "data"), "tall", n_structures=120,
                                         min_atoms=240, max_atoms=300, periodic=True, seed=0,
                                         target_names=("formation_energy_per_atom",))
    cfg = ScannConfig(model=mp2018,
                      hyper=HyperConfig(batch_size=16, scheduler="sgdr", lr=5e-4, min_lr=1e-4,
                                        target="formation_energy_per_atom",
                                        data_energy_path=energy, data_nei_path=nbr, epochs=2,
                                        seed=0, save_path=os.path.join(work, "fit")),
                      tpu=TpuConfig(max_buckets=1, neighbors_pad_multiple=32))
    fit = Scann(cfg, device="cuda")
    fit.prepare_dataset()
    fit.init_params(cfg.hyper.seed)                # what fit() would draw
    trainer, train = fit.trainer, fit.train_buckets
    print(f"phase 18: 120 synthetic periodic crystals of 240-300 sites written and featurized "
          f"on the host in {time.time() - t0:.1f} s; buckets {[b.shape for b in train]} "
          f"({[b.num_structures for b in train]} structures)", flush=True)
    route = trainer.train_route(*train[0].shape)
    before = bucket_losses(trainer, train)
    # the fit's first step through the Trainer against the plain version
    idx, seeds = trainer.epoch_plan(0, 0, train[0].num_structures, cfg.hyper.batch_size)
    xb, yb = trainer._put_buckets(train, "train")[0]
    rows = idx[0].cuda()
    xb, yb = {k: v[rows] for k, v in xb.items()}, yb[rows]
    pred, raw = trainer.raw_grads(xb, yb, seeds[0])
    want_pred, want = kloop.reference_loop_train_grads(
        trainer.params, xb, yb, mp2018, trainer.mrelu_head, trainer.dropout_rate, seeds[0])
    step_err = max(float((raw[k] - want[k]).abs().max() / (want[k].abs().max() + 1e-30))
                   for k in want)
    pred_err = float((pred - want_pred[:, 0]).abs().max())
    print(f"phase 18 the Trainer's first step at {tuple(xb['neighbors'].shape)} (C = "
          f"{kloop.cluster_size(len(rows))}, its kept scratch {sorted(trainer._loop_scratch)}): "
          f"gradients within {step_err:.3e} x max of the plain version (limit {GRAD_RTOL}), "
          f"pred {pred_err:.3e}", flush=True)
    if not (step_err <= GRAD_RTOL and pred_err <= ATOL + RTOL * float(want_pred.abs().max())):
        failures.append(f"phase 18 the Trainer's first tall step: gradients {step_err:.3e} x "
                        f"max, pred {pred_err:.3e} from the plain version")
    c4 = kloop.launch_loop_backward
    kbwd.reset_counts(c4)
    f3.tall_launches = 0
    t0 = time.time()
    hist = fit.train()
    torch.cuda.synchronize()
    wall = time.time() - t0
    trained = (c4.launches, c4.tall_launches, f3.tall_launches)
    after = bucket_losses(trainer, train)
    steps = 2 * -(-train[0].num_structures // cfg.hyper.batch_size)
    print(f"phase 18 trained 2 epochs in the bucket {train[0].shape} (route {route}) in "
          f"{wall:.1f} s: {steps} steps, #4 launches {trained[0]} ({trained[1]} tall; "
          f"{mode_counts(c4)}), #3 tall launches {trained[2]} (validation); loss "
          f"{hist['loss']}; the bucket's loss without dropout {before[0]:.6f} -> "
          f"{after[0]:.6f}  [{card}]", flush=True)
    if (len(train) != 1 or route != "loop" or trained[:2] != (steps, steps)
            or trained[2] < 1):
        failures.append(f"phase 18 training: buckets {[b.shape for b in train]}, route {route}, "
                        f"#4 launches {trained[0]} ({trained[1]} tall) for {steps} steps, #3 "
                        f"tall {trained[2]}")
    if not (all(np.isfinite(hist["loss"])) and hist["loss"][-1] < hist["loss"][0]
            and np.isfinite(after[0]) and after[0] < before[0]):
        failures.append(f"phase 18 training: losses {hist['loss']}, the bucket's "
                        f"{before[0]} -> {after[0]}")
    plain = plain_loop_trainer()(cfg, "cuda", os.path.join(work, "plain"))
    plain.init_state(cfg.hyper.seed)
    plain_hist = plain.fit(train, fit.valid_buckets, log_fn=lambda *a: None)
    plain_after = bucket_losses(plain, train)
    mine = hist["loss"] + hist["val_mae"] + after
    ref = plain_hist["loss"] + plain_hist["val_mae"] + plain_after
    rel = max(abs(a - b) / abs(b) for a, b in zip(mine, ref))
    print(f"phase 18 the same epochs with the plain step: losses {plain_hist['loss']}, the "
          f"bucket's {plain_after[0]:.6f}; max rel {rel:.3e} from the kernel's (limit "
          f"{TRAIN_RTOL})", flush=True)
    if not rel <= TRAIN_RTOL:
        failures.append(f"phase 18 kernel and plain epochs at {train[0].shape} differ: "
                        f"{rel:.3e}")
    return ({"scann_loop_tall": served[1] + trained[2], "scann_loop_backward_tall": trained[1]},
            (energy, nbr))


def phase18(mp2018, ptgp, failures, card):
    """Phase 18: tall structures. Returns the kernels line's rows of the two
    tall builds and the files of its training set."""
    from scann_tpu_torch.kernels import scann_loop as kloop

    t0 = time.time()
    err3, err4 = phase18_holds(mp2018, ptgp, failures)
    t1 = time.time()
    t3, t4 = phase18_times(mp2018, ptgp, card)
    t2 = time.time()
    launches, data = phase18_paths(mp2018, failures, card)
    print(f"phase 18 wall (s): holds {t1 - t0:.1f}, times {t2 - t1:.1f}, main paths "
          f"{time.time() - t2:.1f}", flush=True)
    return data, [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches[name], "max_abs_err": err, "library_ms": None,
             **{k: v for k, v in t.items() if k != "cluster"}}
            for name, source, replaces, err, t in (
                ("scann_loop_tall", "scann_tpu_torch/csrc/scann_loop_tall.cu", kloop.REPLACES,
                 err3, t3),
                ("scann_loop_backward_tall", "scann_tpu_torch/csrc/scann_loop_backward_tall.cu",
                 kloop.BACKWARD_REPLACES, err4, t4))]

# ---- phase 19: the bf16 operand mode in the wide and tall builds of #3 and #4 ---------------

def hold_bf16_shape(label, cfm, x, failures, seed=19, clusters=(1, 2, 4), below=0.9,
                    below_pred=None, clusters3=HOLD_CLUSTERS, grads=True, jitters=0):
    """#3 and #4 in the bf16 operand mode in the build that (``cfm``, ``x``)
    takes, against their bf16 plain versions with phases 14-15's criteria.
    #3 (``hold_bf16``: within the larger of 0.1 x the plain bf16-vs-f32 gap
    and 2 x the f32-noise floor, and ``below`` x the f32 kernel's reading;
    at full depth every output within rtol 0.05 / atol 0.02 of the f32
    kernel) at dropout 0 at each of ``clusters3`` blocks a structure and at
    the wrapper's own (``kloop.forward_cluster``), each relaunched on NaN-
    and constant-filled scratch bit for bit, and at dropout 0.1 with
    attention dropout at its own. #4
    (one-shot, dropout 0.1) at each of ``clusters`` in its three schedules:
    recompute against the bf16 plain version (``hold_bf16_grads``,
    ``below`` x the f32 kernel's reading), the f32 stash bit-equal to it,
    the bf16 stash against its own plain version
    (``kloop.reference_loop_stash_train_grads`` in the bf16 operand mode),
    the f32 stash and recompute each relaunched on NaN- and constant-filled
    scratch bit for bit. Phases 14-15 hold at 0.9 x with the model's
    layers and at 0.5 x with one, where the f32-noise floor is lower;
    ``below_pred`` sets #4's pred apart (``hold_bf16_grads``). Without
    ``grads`` (a width past #4's), #3 alone. With ``jitters``, #3's
    f32-noise floor also takes that many runs of its bf16 plain version on
    moved weights (``jittered``). Returns (worst #3 error, worst #4 error
    or None)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    cfm16 = dataclasses.replace(cfm, dtype="bfloat16")
    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    build3 = kloop.forward_library(cfm16, M, N)[0]
    p = init_params(cfm, torch.Generator().manual_seed(seed), "cuda")
    packed = kfwd.pack_params(p, cfm)
    kfwd._check_inputs(x, cfm, packed["wde"].device)
    tag = f"{label} B={B} M={M} N={N}"
    worst3 = worst4 = 0.0
    full = cfm.n_attention > 1
    own3 = kloop.forward_cluster(cfm16, B, M, N)
    for rate, at in ((0.0, sorted(set(clusters3) | {own3})), (0.1, (own3,))):
        with torch.inference_mode():
            plain16 = kloop.reference_loop_forward(p, x, cfm16, False, rate, 11)
            plain32 = kloop.reference_loop_forward(p, x, cfm, False, rate, 11)
            f64 = kloop.reference_loop_forward(f64_params(p), x, cfm16, False, rate, 11)
            moved = [kloop.reference_loop_forward(jittered(p, j), x, cfm16, False, rate, 11)
                     for j in range(jitters)]
        for C in at:
            differ = set()
            with torch.inference_mode():
                got16 = kloop._launch(packed, x, cfm16, False, rate, 11, 0, C)
                got32 = kloop._launch(packed, x, cfm, False, rate, 11, 0, C)
                if not rate:
                    scratch = kloop.loop_forward_scratch(cfm16, B, M, N, "cuda", C)
                    for fill in (float("nan"), -3.0):
                        for t in scratch.values():
                            if t is not None:
                                t.fill_(fill)
                        again = kloop._launch(packed, x, cfm16, False, rate, 11, 0, C, scratch)
                        differ |= {w for w, a, b in zip(("pred", "ga"), again, got16)
                                   if not torch.equal(a, b)}
                    del scratch
            torch.cuda.synchronize()
            name = f"{tag} #3 bf16 ({build3}) C={C} dropout {rate}"
            worst3 = max(worst3, hold_bf16(name, got16, plain16, plain32, got32, failures, f64,
                                           versus_f32=full, below_f32=below,
                                           plain16_moved=moved))
            if not rate:
                print(f"{name}: 2 launches on NaN- and constant-filled scratch bit-identical: "
                      f"{not differ}", flush=True)
                if differ:
                    failures.append(f"{name}: relaunches differ in {sorted(differ)}")
        del plain16, plain32, f64, moved
    if not grads:
        return worst3, None
    build4 = kloop.backward_library(cfm16, M, N)
    rate = 0.1
    y = torch.from_numpy(np.random.default_rng(seed).normal(size=(B, 1)).astype(np.float32)).cuda()
    run = lambda q, c: kloop.reference_loop_train_grads(q, x, y, c, False, rate, 7)
    stash = lambda q: kloop.reference_loop_stash_train_grads(q, x, y, cfm16, False, rate, 7,
                                                             mode="bf16")
    plain16, plain32, plain_st = run(p, cfm16), run(p, cfm), stash(p)
    floors = [run(f64_params(p), cfm16)] + [run(jittered(p, j), cfm16) for j in range(JITTERS)]
    st_floors = [stash(f64_params(p))] + [stash(jittered(p, j)) for j in range(JITTERS)]
    for C in clusters:
        got, differ = {}, set()
        for mode in ("f32", None, "bf16"):
            scratch = kloop.loop_backward_scratch(packed, cfm16, B, M, N, C, mode)
            for i in range(1 if mode == "bf16" else 3):
                if i:
                    for t in scratch.values():
                        if t is not None:
                            t.fill_(float("nan") if i == 1 else -3.0)
                out = backward_launch(4, packed, x, y, cfm16, rate, 7, scratch, C, stash=mode)
                if not i:
                    got[mode] = (out[0].clone(), {k: v.clone() for k, v in out[1].items()})
                    continue
                differ |= {f"{mode} {k}" for k in out[1] if not torch.equal(out[1][k],
                                                                           got[mode][1][k])}
                if not torch.equal(out[0], got[mode][0]):
                    differ.add(f"{mode} pred")
            del scratch
        got32 = backward_launch(4, packed, x, y, cfm, rate, 7, None, C, stash=None)
        torch.cuda.synchronize()
        name = f"{tag} #4 bf16 ({build4}) C={C} dropout {rate}"
        worst4 = max(worst4, hold_bf16_grads(f"{name} recompute", got[None], plain16, plain32,
                                             floors, got32, failures, below, below_pred))
        same = (torch.equal(got["f32"][0], got[None][0])
                and all(torch.equal(got["f32"][1][k], got[None][1][k]) for k in got[None][1]))
        print(f"{name}: the f32 stash bit-equal to recompute: {same}; 2 relaunches each of the "
              f"f32 stash and recompute on NaN- and constant-filled scratch bit-identical: "
              f"{not differ}", flush=True)
        if not same:
            failures.append(f"{name}: the f32 stash differs from recompute")
        if differ:
            failures.append(f"{name}: relaunches differ in {sorted(differ)[:6]}")
        worst4 = max(worst4, hold_bf16_grads(f"{name} bf16 stash", got["bf16"], plain_st, plain32,
                                             st_floors, got32, failures, below, below_pred))
    return worst3, worst4


def phase19_holds(mp2018, ptgp, failures):
    """The four bf16 builds against their plain versions (``hold_bf16_shape``;
    #3 at every size of ``HOLD_CLUSTERS`` over each build's two shapes,
    ``held_sizes``) at the wide shapes MP2018 (4, 96, 72) and (4, 80, 96) and the tall ones
    Pt/graphene (2, 322, 32) and MP2018 (2, 428, 16), full width and depth,
    attention dropout on, and again with one layer over 16 structures at
    their cluster size (0.5 x the f32 kernel's reading, #4's pred 0.9 x);
    then the tall builds in bf16 forced (``tall=True``) at MP2018 (4, 96,
    32) and Pt/graphene (4, 128, 32) against the narrow bf16 builds
    (``tall_against_narrow``: #3 bit for bit, #4 within its gradient
    limit). Returns the worst errors by row name."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_loop as kloop

    rng = np.random.default_rng(19)
    mp_drop = dataclasses.replace(mp2018, use_drop=True)
    pt_drop = dataclasses.replace(ptgp, use_drop=True)
    pt = dict(use_ring=True, n_atoms=ptgp.n_atoms)
    # (build, name, config, the batch of B structures at the shape)
    cases = (("wide", "MP2018", mp_drop, lambda B: wide_batch(rng, B, 96, 72, mp2018)),
             ("wide", "MP2018", mp_drop, lambda B: wide_batch(rng, B, 80, 96, mp2018)),
             ("tall", "Pt/graphene", pt_drop,
              lambda B: synthetic_batch(rng, B, 322, 32, min_atoms=300, **pt)),
             ("tall", "MP2018", mp_drop,
              lambda B: synthetic_batch(rng, B, 428, 16, n_atoms=mp2018.n_atoms, min_atoms=400)))
    worst = {}
    for i, (build, name, cfm, batch) in enumerate(cases):
        t0 = time.time()
        x = batch(4 if build == "wide" else 2)
        M, N = x["atom_mask"].shape[1], x["neighbors"].shape[2]
        shaped = (kloop.is_wide_backward(cfm, N) if build == "wide"
                  else kloop.is_tall(cfm, M, N) and kloop.is_tall_backward(cfm, M, N))
        if not shaped:
            raise AssertionError(f"phase 19: {name} {(M, N)} is not a {build} shape")
        # each build's two shapes: #3 at every size of HOLD_CLUSTERS between them
        w3, w4 = hold_bf16_shape(f"phase 19 {name}", cfm, x, failures,
                                 clusters3=held_sizes(i % 2, 2))
        # one layer over 16 structures at 0.5 x the f32 kernel's reading, but
        # #4's training pred at 0.9 x: at these shapes its f32-noise floor
        # (the plain version against itself on weights moved by 1e-7) is
        # 1.1-1.7 x its whole bf16-vs-f32 gap at one layer, 2 or 16
        # structures alike, where no kernel, the plain version included,
        # reads below 0.5 x the f32 kernel's distance
        one = hold_bf16_shape(f"phase 19 {name} L=1", dataclasses.replace(cfm, n_attention=1),
                              batch(16), failures, clusters=(kloop.cluster_size(16),), below=0.5,
                              below_pred=0.9, clusters3=())
        w3, w4 = max(w3, one[0]), max(w4, one[1])
        # #3 runs narrow at N = 72 and below: its wide row takes N > 64 only
        if build == "tall" or kloop.is_wide_forward(cfm, N):
            worst[f"3-{build}-bf16"] = max(worst.get(f"3-{build}-bf16", 0.0), w3)
        worst[f"4-{build}-bf16"] = max(worst.get(f"4-{build}-bf16", 0.0), w4)
        print(f"phase 19 holds at {name} {tuple(x['neighbor_mask'].shape)}: "
              f"{time.time() - t0:.1f} s", flush=True)
    bf16 = lambda cfm: dataclasses.replace(cfm, dtype="bfloat16")
    tall_against_narrow("phase 19 MP2018 bf16", bf16(mp2018),
                        synthetic_batch(rng, 4, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20),
                        failures)
    tall_against_narrow("phase 19 Pt/graphene bf16", bf16(ptgp),
                        synthetic_batch(rng, 4, 128, 32, min_atoms=20, **pt), failures)
    return worst


def phase19_times(mp2018, ptgp, card):
    """Each bf16 build in turns with its f32 build (f32, bf16, bf16, f32) at
    the f32 rows' shapes, C = 4: the wide builds at MP2018 (16, 80, 96), the
    tall ones at Pt/graphene (16, 322, 32); #4 one-shot at dropout 0.1 in
    the schedule both take there (the f32 stash). Beside them the bf16
    plain versions' times and the work. Returns {row name: ((bf16 ms, f32
    ms), plain ms, FLOP, FLOP on the CUDA cores, bytes)}."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(191)
    out = {}
    for build, name, cfm, x in (
            ("wide", "MP2018", mp2018, wide_batch(rng, 16, 80, 96, mp2018)),
            ("tall", "Pt/graphene", ptgp, synthetic_batch(rng, 16, 322, 32, use_ring=True,
                                                          n_atoms=ptgp.n_atoms, min_atoms=240))):
        cfm16 = dataclasses.replace(cfm, dtype="bfloat16")
        params = init_params(cfm, torch.Generator().manual_seed(0), "cuda")
        packed = kfwd.pack_params(params, cfm)
        B, M = x["atom_mask"].shape[:2]
        N = x["neighbors"].shape[2]
        y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        with torch.inference_mode():
            scratch = kloop.loop_forward_scratch(cfm, B, M, N, "cuda")
            t3 = in_turns_ms(lambda: kloop._launch(packed, x, cfm, False, 0.0, 0, 0, None, scratch),
                             lambda: kloop._launch(packed, x, cfm16, False, 0.0, 0, 0, None,
                                                   scratch), 3, 10)
            plain3 = cuda_ms(lambda: kloop.reference_loop_forward(params, x, cfm16), 3)
            del scratch
        mode = kloop.loop_stash_mode(cfm, B, M, N)
        scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, stash=mode)
        launch = lambda c: kloop._launch_backward(packed, x, c, y, None, True, False, 0.1, 7, 0,
                                                  scratch, stash=mode)
        t4 = in_turns_ms(lambda: launch(cfm), lambda: launch(cfm16), 3, 8)
        del scratch
        plain4 = statistics.median(cuda_times(lambda: chunked_train_grads(
            kloop.reference_loop_train_grads, params, x, y, cfm16, False, 0.1, 7, 4), 2,
            warmup=1))
        _, P = kbwd.grad_layout(packed)
        common = tensor_bytes(x.values(), weights(packed))
        out[f"3-{build}-bf16"] = (t3, plain3, kloop.loop_forward_flops(cfm, B, M, N),
                                  kfwd.forward_fp32_flops(cfm, B, M, N),
                                  common + 4 * (B + B * M) + kloop.loop_forward_bytes(cfm, B, M, N))
        out[f"4-{build}-bf16"] = (t4, plain4, kloop.loop_backward_flops(cfm, B, M, N),
                                  kbwd.backward_fp32_flops(cfm, B, M, N),
                                  common + 4 * B + 4 * (P + B))
        clusters = {3: kloop.forward_cluster(cfm, B, M, N), 4: kloop.cluster_size(B)}
        for n, (t, plain) in ((3, (t3, plain3)), (4, (t4, plain4))):
            print(f"phase 19 #{n} {build} at {name} B={B} M={M} N={N}, C={clusters[n]}"
                  f"{'' if n == 3 else f' (the {mode} stash, dropout 0.1, one-shot)'} (timed in "
                  f"turns: f32, bf16, bf16, f32): bf16 {t[0]:.4f} ms, f32 {t[1]:.4f} ms "
                  f"({100 * (t[0] / t[1] - 1):+.1f}%), bf16 plain {plain:.4f} ms  [{card}]",
                  flush=True)
    return out


def phase19_paths(mp2018, data, failures, card):
    """The main paths in bf16 at wide and tall shapes, through the entry points
    a user calls, with the launch counts set to 0 just before:
    ``Scann.predict_featurized`` on a bf16 MP2018 model of a crystal whose
    ladder N is 96 (48, 96) and of one of 300 sites (384, 96), both through
    #3's wide build in bf16, held to the bf16 plain version within rtol
    0.05 / atol 0.02, and of the 300-site crystal to a bf16 MP2018 model
    without the attention LayerNorm (the per-layer route: #5's wide build in
    bf16 on each layer), held to the bf16 eager model alike; then
    ``Scann.train`` of a bf16 MP2018 model, 2 epochs on phase 18's crystals
    in its bucket (304, 32) (#4's tall build in bf16, one launch a step;
    the validation batches by #3's tall build in bf16), whose first step
    through the Trainer is held to the bf16 plain version first
    (``hold_bf16_grads``, 0.9 x the f32 kernel's reading), every epoch loss
    finite; then one training step of a bf16 and of an f32 MP2018 model
    without the attention LayerNorm at (248, 64), which #4 refuses: the
    per-layer route in both, no kernel launch, the bf16 loss finite and
    within rtol 0.05 of the f32 one.
    Returns the launches of the four builds on these paths."""
    import dataclasses
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import scann_forward
    from scann_tpu_torch.train.loop import Trainer

    mp16 = dataclasses.replace(mp2018, dtype="bfloat16")
    rng = np.random.default_rng(192)
    work = tempfile.mkdtemp(prefix="scann_chip_smoke_bf16_shapes_")
    scann = Scann(ScannConfig(model=mp16, hyper=HyperConfig(batch_size=16, seed=0,
                                                            save_path=os.path.join(work, "run"))),
                  device="cuda")
    scann.init_params(0)
    records = [wide_batch(rng, 1, na, 80, mp2018, min_atoms=na, edges=False) for na in (40, 300)]
    inputs = [{k: v.cpu().numpy() for k, v in x.items()} for x in records]
    structs = [Structure(["Si"] * na, rng.uniform(0, 9, size=(na, 3)), np.eye(3) * 9.0)
               for na in (40, 300)]
    f3, f5, f4 = kloop.launch_loop_forward, kla.fused_local_attention, kloop.launch_loop_backward
    for c in (f3, f5):
        c.launches = c.bf16_launches = c.wide_launches = 0
    answers = scann.predict_featurized(structs, inputs, batch_size=4)
    torch.cuda.synchronize()
    served = {"loop": (f3.launches, f3.bf16_launches, f3.wide_launches),
              "per_layer": (f5.launches, f5.bf16_launches, f5.wide_launches)}
    routes = [scann.trainer.eval_route(48, 96), scann.trainer.eval_route(384, 96)]
    hyper = scann.config.hyper
    held = []
    for (pred, ga), x, route in zip(answers, records, routes):
        with torch.inference_mode():
            want = (kloop.reference_loop_forward(scann.params, x, mp16) if route == "loop"
                    else scann_forward(scann.params, x, mp16))[0]
        want = want[0, 0].item() * hyper.target_std + hyper.target_mean
        held.append(abs(pred - want) <= BF16_ATOL + BF16_RTOL * abs(want)
                    and len(ga) == x["atomic"].shape[1])
        print(f"phase 19 served {x['atomic'].shape[1]} sites (route {route}): {pred:.6f} against "
              f"the bf16 {'plain version' if route == 'loop' else 'eager model'}'s {want:.6f}",
              flush=True)
    print(f"phase 19 served on a bf16 MP2018 model: routes {routes}; launches (all, bf16, "
          f"wide) {served}", flush=True)
    if (routes != ["loop", "loop"] or served["loop"] != (2, 2, 2)
            or served["per_layer"][0] or not all(held)):
        failures.append(f"phase 19 served: routes {routes}, launches {served}, answers held "
                        f"{held}")
    # the crystal of 300 sites to a bf16 model without the attention
    # LayerNorm, which no whole-model kernel takes: the per-layer model, #5's
    # wide build in bf16 on each layer
    plain = Scann(ScannConfig(model=dataclasses.replace(mp16, use_attn_norm=False),
                              hyper=HyperConfig(batch_size=16, seed=0,
                                                save_path=os.path.join(work, "plain"))),
                  device="cuda")
    plain.init_params(0)
    for c in (f3, f5):
        c.launches = c.bf16_launches = c.wide_launches = 0
    (pred, ga), = plain.predict_featurized(structs[1:], inputs[1:], batch_size=4)
    torch.cuda.synchronize()
    layered = {"loop": f3.launches, "per_layer": (f5.launches, f5.bf16_launches, f5.wide_launches)}
    layer_route = plain.trainer.eval_route(384, 96)
    with torch.inference_mode():
        want = scann_forward(plain.params, records[1], plain.config.model)[0]
    want = want[0, 0].item() * plain.config.hyper.target_std + plain.config.hyper.target_mean
    layer_held = (abs(pred - want) <= BF16_ATOL + BF16_RTOL * abs(want)
                  and len(ga) == records[1]["atomic"].shape[1])
    print(f"phase 19 served 300 sites to a bf16 MP2018 model without the attention LayerNorm "
          f"(route {layer_route}): {pred:.6f} against the bf16 eager model's {want:.6f}; "
          f"launches #3 {layered['loop']}, #5 (all, bf16, wide) {layered['per_layer']}",
          flush=True)
    if (layer_route != "per_layer" or layered["loop"]
            or layered["per_layer"] != (mp2018.n_attention,) * 3 or not layer_held):
        failures.append(f"phase 19 served without the attention LayerNorm: route {layer_route}, "
                        f"launches {layered}, answer held {layer_held}")

    energy, nbr = data
    cfg = ScannConfig(model=mp16,
                      hyper=HyperConfig(batch_size=16, scheduler="sgdr", lr=5e-4, min_lr=1e-4,
                                        target="formation_energy_per_atom",
                                        data_energy_path=energy, data_nei_path=nbr, epochs=2,
                                        seed=0, save_path=os.path.join(work, "fit")),
                      tpu=TpuConfig(max_buckets=1, neighbors_pad_multiple=32))
    fit = Scann(cfg, device="cuda")
    fit.prepare_dataset()
    fit.init_params(cfg.hyper.seed)
    trainer, train = fit.trainer, fit.train_buckets
    route = trainer.train_route(*train[0].shape)
    idx, seeds = trainer.epoch_plan(0, 0, train[0].num_structures, cfg.hyper.batch_size)
    xb, yb = trainer._put_buckets(train, "train")[0]
    rows = idx[0].cuda()
    xb, yb = {k: v[rows] for k, v in xb.items()}, yb[rows]
    got16 = trainer.raw_grads(xb, yb, seeds[0])
    got16 = (got16[0].clone(), {k: v.clone() for k, v in got16[1].items()})
    packed = kfwd.pack_params(trainer.params, mp2018)
    flat, pred = kloop._launch_backward(packed, xb, mp2018, yb, None, True, trainer.mrelu_head,
                                        trainer.dropout_rate, seeds[0], 0)
    got32 = (pred, kbwd.grads_from_flat(flat, packed, mp2018))
    run = lambda p, c: chunked_train_grads(kloop.reference_loop_train_grads, p, xb, yb, c,
                                           trainer.mrelu_head, trainer.dropout_rate, seeds[0], 4)
    params = trainer.params
    err = hold_bf16_grads(
        f"phase 19 the Trainer's first bf16 step at {tuple(xb['neighbors'].shape)} (C = "
        f"{kloop.cluster_size(len(rows))}, {kloop.backward_library(mp16, *train[0].shape)})",
        got16, run(params, mp16), run(params, mp2018),
        [run(f64_params(params), mp16)] + [run(jittered(params, j), mp16) for j in range(JITTERS)],
        got32, failures, 0.9)
    kbwd.reset_counts(f4)
    f3.launches = f3.bf16_launches = f3.tall_launches = 0
    t0 = time.time()
    hist = fit.train()
    torch.cuda.synchronize()
    trained = (f4.launches, f4.bf16_launches, f4.tall_launches)
    valid = (f3.bf16_launches, f3.tall_launches)
    steps = 2 * -(-train[0].num_structures // cfg.hyper.batch_size)
    print(f"phase 19 trained a bf16 MP2018 model 2 epochs in the bucket {train[0].shape} (route "
          f"{route}) in {time.time() - t0:.1f} s: {steps} steps, #4 launches (all, bf16, tall) "
          f"{trained} ({mode_counts(f4)}), #3 (bf16, tall) {valid} (validation); loss "
          f"{hist['loss']}  [{card}]", flush=True)
    if (len(train) != 1 or route != "loop" or trained != (steps,) * 3 or valid[1] < 1
            or valid[0] != valid[1] or not all(np.isfinite(hist["loss"]))):
        failures.append(f"phase 19 bf16 training: buckets {[b.shape for b in train]}, route "
                        f"{route}, #4 launches {trained} for {steps} steps, #3 {valid}, losses "
                        f"{hist['loss']}")

    # one step of the third route in bf16 and f32: MP2018 without the
    # attention LayerNorm, which the loop backward refuses (with it the wide
    # #4 takes (248, 64))
    M, N, B = 248, 64, 8
    x = synthetic_batch(np.random.default_rng(10), B, M, N, n_atoms=mp2018.n_atoms,
                        min_atoms=150)
    y = torch.from_numpy(np.random.default_rng(11).normal(size=B).astype(np.float32)).cuda()
    step = {}
    for cfm in (dataclasses.replace(mp16, use_attn_norm=False),
                dataclasses.replace(mp2018, use_attn_norm=False)):
        t = Trainer(ScannConfig(model=cfm, hyper=HyperConfig(batch_size=B, seed=0)), "cuda",
                    os.path.join(work, f"third_{cfm.dtype}"))
        t.init_state(5)
        before = (f5.launches, f4.launches)
        loss, _ = t.train_step(x, y, 5e-4, 3)
        step[cfm.dtype] = (t.train_route(M, N), float(loss),
                           (f5.launches - before[0], f4.launches - before[1]))
    rel = abs(step["bfloat16"][1] - step["float32"][1]) / abs(step["float32"][1])
    print(f"phase 19 one training step at B={B} M={M} N={N} (MP2018 without the attention "
          f"LayerNorm, which #4 refuses): (route, loss, "
          f"launches of #5 and #4) bf16 {step['bfloat16']}, f32 {step['float32']}; rel "
          f"{rel:.3e} (limit {BF16_RTOL})", flush=True)
    if (any(r != "per_layer" or n != (0, 0) for r, _, n in step.values())
            or not np.isfinite(step["bfloat16"][1]) or not rel <= BF16_RTOL):
        failures.append(f"phase 19 per-layer bf16 step: {step}")
    return {"3-wide-bf16": served["loop"][2], "3-tall-bf16": valid[1],
            "4-tall-bf16": trained[2], "5-wide-bf16": layered["per_layer"][1]}, err


def phase19(mp2018, ptgp, data, launched, layer16, failures, card):
    """Phase 19: the bf16 operand mode in the wide and tall builds of #3 and
    #4 (holds, times, main paths). ``data``: phase 18's training set;
    ``launched``: the launches of these builds on earlier phases' main paths
    (phase 14's served 260-site crystal, #3 tall; phase 15's (96, 64)
    bucket, #4 wide); ``layer16``: phase 17's holds and times of #5's wide
    build on bf16 tensors, whose main-path launches are this phase's
    request to a bf16 model without the attention LayerNorm. Returns the
    kernels line's five rows."""
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_loop as kloop

    t0 = time.time()
    worst = phase19_holds(mp2018, ptgp, failures)
    t1 = time.time()
    times = phase19_times(mp2018, ptgp, card)
    t2 = time.time()
    launches, step_err = phase19_paths(mp2018, data, failures, card)
    worst["4-tall-bf16"] = max(worst["4-tall-bf16"], step_err)
    print(f"phase 19 wall (s): holds {t1 - t0:.1f}, times {t2 - t1:.1f}, main paths "
          f"{time.time() - t2:.1f}", flush=True)
    launches["3-tall-bf16"] += launched["scann_loop_tall_bf16"]
    launches["4-wide-bf16"] = launched["scann_loop_backward_wide_bf16"]
    rows = []
    for name, kernel, source in (
            ("3-wide-bf16", "scann_loop_wide", "scann_tpu_torch/csrc/scann_loop_wide.cu"),
            ("3-tall-bf16", "scann_loop_tall", "scann_tpu_torch/csrc/scann_loop_tall.cu"),
            ("4-wide-bf16", "scann_loop_backward_wide_bf16",
             "scann_tpu_torch/csrc/scann_loop_backward_wide_bf16.cu"),
            ("4-tall-bf16", "scann_loop_backward_tall_bf16",
             "scann_tpu_torch/csrc/scann_loop_backward_tall_bf16.cu")):
        replaces = kloop.REPLACES if name[0] == "3" else kloop.BACKWARD_REPLACES
        rows.append(bf16_row(name, kernel, source, replaces, launches[name], worst[name],
                             *times[name], card))
        if not launches[name]:
            failures.append(f"phase 19: {name} was not launched on a main path")
    rows.append(bf16_row("5-wide-bf16", "local_attention_wide_bf16",
                         "scann_tpu_torch/csrc/local_attention_wide.cu", kla.REPLACES,
                         launches["5-wide-bf16"], *layer16, card, bf16_products=False))
    return rows


# ---- phase 20: widths above 128 (D, G, O up to 256) in #1, #3 and #5 ------------------------

D256_WIDTHS = ((136, 132, 140), (256, 256, 256))   # one that does not divide 256, and 256


def widened(cfm, D, G, O):
    """``cfm`` at widths (D, G, O), 8 heads as published."""
    import dataclasses

    return dataclasses.replace(cfm, local_dim=D, global_dim=G, dense_out=O)


def hold_fused_clusters(tag, packed, x, cfm, drop, got, got16, failures):
    """#1 past 128 columns at every size of ``HOLD_CLUSTERS`` that the batch
    takes (at most one block a chunk of atoms), f32 and bf16 (``drop``: the
    dropout rate, seed and ``mol_base``): bit for bit what the rule's size
    gave (``got``, ``got16``), since every product, softmax and LayerNorm is
    a row's or an atom's. Past 256 columns each launch also runs on L2 rows
    (``kfwd.l2_rows_shape``) filled with NaN, at the rule's size too."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd

    B, M = x["atomic"].shape[:2]
    N = x["neighbors"].shape[2]
    S = x["segment_onehot"].shape[-1] if "segment_onehot" in x else 0
    cfm16 = dataclasses.replace(cfm, dtype="bfloat16")
    sizes = [C for C in HOLD_CLUSTERS if C <= kfwd.chunk_count(cfm, M, N, S)]
    rows = kfwd.l2_rows_shape(cfm, B, M)
    if rows is not None:
        sizes = sorted(set(sizes) | {kfwd.forward_cluster(cfm, B, M, N, S)})
    differ = []
    with torch.inference_mode():
        for C in sizes:
            for mode, want in ((cfm, got), (cfm16, got16)):
                nan = None if rows is None else torch.full(rows, float("nan"), device="cuda")
                out = kfwd._launch(packed, x, mode, False, *drop, cluster=C, l2_rows=nan)
                if not all(torch.equal(a, b) for a, b in zip(out, want)):
                    differ.append(f"{mode.dtype} C={C}")
    print(f"{tag}: at C = {sizes} (the rule's {kfwd.forward_cluster(cfm, B, M, N, S)}), f32 "
          f"and bf16{'' if rows is None else ', on NaN-filled L2 rows'}, bit for bit: "
          f"{not differ}", flush=True)
    if differ:
        failures.append(f"{tag}: differs from the rule's cluster at {differ}")


def phase20_holds(qm9_model, mp2018, failures):
    """Every *_d256 build against its plain version at (D, G, O) =
    (136, 132, 140) and (256, 256, 256), f32 and bf16: #1 at QM9 (16, 32,
    16) and (8, 8, 8) of 1-8 atoms, at D = 256 also on a packed batch (QM9
    at capacity 48) and with dropout on (rtol/atol, a relaunch bit-identical,
    every cluster size the batch takes bit for bit, ``hold_fused_clusters``;
    bf16 by ``hold_bf16`` at 2 x the f32-noise floor and 0.9 x the f32
    kernel's reading; the floor of every phase 20 bf16 hold is phase 15's,
    the plain version's largest distance from itself with f64 sums or on
    ``JITTERS`` weights moved by about one f32 ulp); #3 at MP2018 (4, 96, 32) (the tall build) and (4, 80,
    96) and (3, 40, 48) (the wide one, which takes N > 32 past 128 columns)
    at C = 1, 2, 4 and the rule's C, each relaunched on NaN- and
    constant-filled scratch bit for bit (``hold_loop_forward``; bf16 by
    ``hold_bf16_shape``: within 2 x the f32-noise floor at full depth, and
    under 0.5 x the f32 kernel's reading with one layer over 16 structures;
    #4's bf16 tall and wide d256 builds the same way at (4, 96, 32) and (3,
    40, 48), in their three schedules, at C = 1, 2, 4 at full depth and at
    the rule's C with one layer, pred there at 0.9 x as in phase 19); the
    wide #3 also at its 32-row sub-chunks' edges at D = 256, (2, 40, 33),
    (2, 40, 65), (2, 30, 97) and (2, 24, 80), at every size of
    ``HOLD_CLUSTERS`` with the relaunches, f32 and bf16 at full depth; #5 on
    one layer at (8, 96, 32), (4, 40, 64) and (3, 37, 12) (the narrow
    build: one atom a chunk of 32 rows with two operand buffers, an atom of
    64 rows with one, two atoms a chunk and a ragged last chunk) and (8, 96,
    96), (2, 73, 81), (2, 32, 256), (3, 20, 65) and (2, 30, 97) (the wide
    one: its 32-row sub-chunks whole, a ragged last one of 17 rows, one row
    past two and three), SCANN+, and SCANN at (8, 96, 32), (8, 96, 96) and
    (2, 30, 97), f32 and bf16 tensors, each relaunched into NaN-filled
    outputs (``hold_wide_layer``). Returns {build: worst f32 error} and
    {build: worst bf16 error}."""
    import dataclasses

    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(20)
    worst, worst16 = {}, {}
    note = lambda d, k, v: d.__setitem__(k, max(d.get(k, 0.0), v))
    for D, G, O in D256_WIDTHS:
        qm9, mp = widened(qm9_model, D, G, O), widened(mp2018, D, G, O)
        qm9_16 = dataclasses.replace(qm9, dtype="bfloat16")
        p = init_params(qm9, torch.Generator().manual_seed(20), "cuda")
        packed = kfwd.pack_params(p, qm9)
        for x in (synthetic_batch(rng, 16, 32, 16), synthetic_batch(rng, 8, 8, 8, min_atoms=1)):
            B, M = x["atomic"].shape
            N = x["neighbors"].shape[2]
            tag = f"phase 20 #1 ({kfwd.library(qm9)}) D={D} G={G} O={O} B={B} M={M} N={N}"
            with torch.inference_mode():
                pred, ga = kfwd.fused_scann_forward(p, x, qm9)
                again = kfwd._launch(packed, x, qm9, False)
                pred0, ga0 = kfwd.reference_scann_forward(p, x, qm9)
                got16 = (kfwd._launch(packed, x, qm9_16, False),
                         kfwd.reference_bf16_forward(p, x, qm9_16, exact_pools=True),
                         (pred0, ga0), (pred, ga))
                f64 = kfwd.reference_bf16_forward(f64_params(p), x, qm9_16, exact_pools=True)
                moved = [kfwd.reference_bf16_forward(jittered(p, j), x, qm9_16, exact_pools=True)
                         for j in range(JITTERS)]
                torch.cuda.synchronize()
            note(worst, kfwd.library(qm9), hold(tag, [("pred", pred, pred0, ATOL),
                                                     ("ga", ga, ga0, ATOL)], failures))
            same = all(torch.equal(a, b) for a, b in zip(again, (pred, ga)))
            print(f"{tag}: a relaunch bit-identical: {same}", flush=True)
            if not same:
                failures.append(f"{tag}: a relaunch differs")
            hold_fused_clusters(tag, packed, x, qm9, (), (pred, ga), got16[0], failures)
            note(worst16, kfwd.library(qm9), hold_bf16(f"{tag} bf16", *got16, failures, f64,
                                                       below_f32=0.9, plain16_moved=moved))
        # at D = 256 also a packed batch (QM9 at capacity 48, empty segments)
        # and a launch with dropout on, each batch from a generator of its own
        # so that the batches drawn after them are the ones they were
        for label, x, drop in () if D != 256 else (
                ("QM9 capacity 48", pack_batch(
                    synthetic_batch(np.random.default_rng(2048), 12, 29, 16), 48), ()),
                ("dropout 0.1", synthetic_batch(np.random.default_rng(2049), 8, 32, 16),
                 (0.1, 27, 40))):
            tag = f"phase 20 #1 ({kfwd.library(qm9)}) D={D} {label}{packed_label(x)}"
            with torch.inference_mode():
                got = kfwd._launch(packed, x, qm9, False, *drop)
                got16 = kfwd._launch(packed, x, qm9_16, False, *drop)
                again = kfwd._launch(packed, x, qm9, False, *drop) + kfwd._launch(
                    packed, x, qm9_16, False, *drop)
                want = kfwd.reference_scann_forward(p, x, qm9, False, *drop)
                plain16 = kfwd.reference_scann_forward(p, x, qm9_16, False, *drop)
                f64 = kfwd.reference_scann_forward(f64_params(p), x, qm9_16, False, *drop)
                moved = [kfwd.reference_scann_forward(jittered(p, j), x, qm9_16, False, *drop)
                         for j in range(JITTERS)]
                torch.cuda.synchronize()
            note(worst, kfwd.library(qm9), hold(tag, [("pred", got[0], want[0], ATOL),
                                                     ("ga", got[1], want[1], ATOL)], failures))
            same = all(torch.equal(a, b) for a, b in zip(again, got + got16))
            print(f"{tag}: a relaunch bit-identical (f32 and bf16): {same}", flush=True)
            if not same:
                failures.append(f"{tag}: a relaunch differs")
            hold_fused_clusters(tag, packed, x, qm9, drop, got, got16, failures)
            note(worst16, kfwd.library(qm9), hold_bf16(f"{tag} bf16", got16, plain16, want, got,
                                                       failures, f64, below_f32=0.9,
                                                       plain16_moved=moved))
        p = init_params(mp, torch.Generator().manual_seed(20), "cuda")
        for B, M, N in ((4, 96, 32), (4, 80, 96), (3, 40, 48)):
            batch = lambda B, M=M, N=N: (
                synthetic_batch(rng, B, M, N, n_atoms=mp.n_atoms, min_atoms=20) if N <= 32
                else wide_batch(rng, B, M, N, mp))
            x = batch(B)
            build = kloop.forward_library(mp, M, N)[0]
            tag = f"phase 20 #3 ({build}) D={D} G={G} O={O}"
            note(worst, build, hold_loop_forward(tag, mp, p, x, failures, clusters=(1, 2, 4),
                                                 relaunches=2))
            # bf16 at full depth within 2 x the f32-noise floor (and near the f32
            # kernel): on these few structures the floor is 0.5-0.9 x the whole
            # bf16-vs-f32 gap, so the f32 kernel's own reading (1.0 x) cannot
            # separate the mode from f32; with one layer over 16 structures the
            # kernel must read under 0.5 x the f32 kernel's, as in phase 19. The
            # floor is phase 15's: f64 sums and weights moved by about one ulp
            # #4's bf16 builds the same way (phase 15's floor rule), at the
            # tall (96, 32) and the wide (40, 48), in their three schedules
            # (with one layer, pred at 0.9 x and at the rule's C, as phase 19)
            grads = N != 96
            build4 = kloop.backward_library(dataclasses.replace(mp, dtype="bfloat16"), M, N)
            for tag, cfm, xb, below, c3, c4 in (
                    (f"phase 20 D={D}", mp, x, None, (1, 2, 4), (1, 2, 4)),
                    (f"phase 20 D={D} L=1", dataclasses.replace(mp, n_attention=1), batch(16),
                     0.5, (), (kloop.backward_cluster(mp, 16, M, N),))):
                w3, w4 = hold_bf16_shape(tag, cfm, xb, failures, below=below, clusters3=c3,
                                         grads=grads, jitters=JITTERS, clusters=c4,
                                         below_pred=0.9 if below else None)
                note(worst16, build, w3)
                if grads:
                    note(worst16, build4, w4)
            del x
        # the wide #3's 32-row sub-chunks at their edges (D = 256): one row past
        # one, two and three of them, and a last one of 16 rows; at every
        # cluster size of HOLD_CLUSTERS, f32 and bf16 (at full depth), each
        # batch from a generator of its own so that the others are as they were
        for B, M, N in ((2, 40, 33), (2, 40, 65), (2, 30, 97), (2, 24, 80)) if D == 256 else ():
            x = wide_batch(np.random.default_rng(N), B, M, N, mp)
            build = kloop.forward_library(mp, M, N)[0]
            note(worst, build, hold_loop_forward(f"phase 20 #3 ({build}) D={D} edge", mp, p, x,
                                                 failures, clusters=HOLD_CLUSTERS, relaunches=2))
            note(worst16, build, hold_bf16_shape(f"phase 20 D={D} edge", mp, x, failures,
                                                 below=None, clusters3=HOLD_CLUSTERS,
                                                 grads=False, jitters=JITTERS)[0])
            del x
        for g_update, (B, M, N) in ((True, (8, 96, 32)), (True, (4, 40, 64)),
                                    (True, (3, 37, 12)),
                                    (True, (8, 96, 96)), (True, (2, 73, 81)),
                                    (True, (2, 32, 256)), (False, (8, 96, 32)),
                                    (False, (8, 96, 96)), (True, (3, 20, 65)),
                                    (True, (2, 30, 97)), (False, (2, 30, 97))):
            # the (3, 37, 12) layer and the wide build's edges (one row past two
            # and three 32-row sub-chunks) draw from generators of their own,
            # so that the batches drawn after them are the ones they were
            own = {12: D, 65: D + 65, 97: D + 97}.get(N)
            args = layer_inputs(rng if own is None else np.random.default_rng(own), B, M, N, D,
                                mp.num_head, g_update)
            if N > 64:
                wide_masks(args[3])
            kla.check_neighbor_range(*kla.index_bounds(args[1]), M)
            build = kla.library(N, D)
            errs = hold_wide_layer(f"phase 20 #5 ({build}) {'scann+' if g_update else 'scann'} "
                                   f"B={B} M={M} N={N} D={D}", args, failures)
            note(worst, build, errs[0])
            note(worst16, build, errs[1])
    return worst, worst16


def turns_ms(plain, kernels, plain_reps=2, kernel_reps=5):
    """One set of turns: plain, each kernel of ``kernels`` (name -> call),
    each again in the reverse order, plain (``plain_reps`` and
    ``kernel_reps`` calls a round, after one warm-up call each), so that a
    drift of the card's clock falls on all alike. Returns ({name: kernel
    ms}, plain ms), medians."""
    for fn in [plain, *kernels.values()]:
        fn()
    torch.cuda.synchronize()
    p = cuda_times(plain, plain_reps, warmup=0)
    kt = {k: [] for k in kernels}
    for k in list(kernels) + list(kernels)[::-1]:
        kt[k] += cuda_times(kernels[k], kernel_reps, warmup=0)
    p += cuda_times(plain, plain_reps, warmup=0)
    return {k: statistics.median(v) for k, v in kt.items()}, statistics.median(p)


def phase20_times(qm9_model, mp2018, card):
    """The *_d256 builds at D = G = O = 256, each in one set of turns with
    its plain version and its bf16 mode (plain, f32, bf16, bf16, f32,
    plain: ``turns_ms``): #1 at QM9 (128, 32, 16), #3 at MP2018 (64, 96,
    32) (the build the gate picks: tall) and (16, 80, 96) (wide), #5 at one
    MP2018 layer (64, 96, 32) and at (8, 96, 96) (on bf16 tensors, and
    ``ms_back_to_back``: 20 launches between two events). Returns {build:
    timing} with the bound (``bound_ms``: the products as three TF32
    passes, the energies and context at FP32, or the bytes; in bf16 the
    products once at the BF16 rate, ``bf16_bound_ms``)."""
    import dataclasses

    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(200)
    qm9, mp = widened(qm9_model, 256, 256, 256), widened(mp2018, 256, 256, 256)
    bf16 = lambda cfm: dataclasses.replace(cfm, dtype="bfloat16")
    out = {}

    def row(build, what, plain, runs, flops, nbytes, fp32, **extra):
        with torch.inference_mode():
            ms, plain_ms = turns_ms(plain, runs)
        bound, by, measured = bound_ms(flops, nbytes, fp32)
        bound16 = bound_ms(flops, nbytes, fp32, bf16=True)[0]
        print(f"{build} at {what} D=256{''.join(f' {k}={v}' for k, v in extra.items())} (timed "
              f"in turns: plain, f32, bf16, bf16, f32, plain): kernel {ms['f32']:.4f} ms, bf16 "
              f"{ms['bf16']:.4f} ms, plain {plain_ms:.4f} ms, {flops:.4e} FLOP, bound "
              f"{bound:.4f} ms by {by} ({100 * bound / ms['f32']:.1f}% of it reached)  [{card}]",
              flush=True)
        out[build] = {"ms": ms["f32"], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                      "measured_bound_ms": measured, "flops": flops, "bf16_ms": ms["bf16"],
                      "bf16_f32_ms": ms["f32"], "bf16_bound_ms": bound16, **extra}

    # #1 at the QM9 serving shape
    p = init_params(qm9, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(p, qm9)
    x = synthetic_batch(rng, 128, 32, 16)
    B, M, N = 128, 32, 16
    kfwd._check_inputs(x, qm9, packed["wde"].device)
    row("scann_forward_d256", f"QM9 B={B} M={M} N={N}",
        lambda: kfwd.reference_scann_forward(p, x, qm9),
        {"f32": lambda: kfwd._launch(packed, x, qm9, False),
         "bf16": lambda: kfwd._launch(packed, x, bf16(qm9), False)},
        kfwd.forward_flops(qm9, B, M, N), tensor_bytes(x.values(), weights(packed))
        + 4 * (B + B * M), kfwd.forward_fp32_flops(qm9, B, M, N),
        cluster=kfwd.forward_cluster(qm9, B, M, N))
    del x
    # #3 at the MP2018 recipe bucket (the tall build) and at (16, 80, 96) (the wide one)
    p = init_params(mp, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(p, mp)
    for B, M, N in ((64, 96, 32), (16, 80, 96)):
        x = (synthetic_batch(rng, B, M, N, n_atoms=mp.n_atoms, min_atoms=20) if N <= 32
             else wide_batch(rng, B, M, N, mp))
        kfwd._check_inputs(x, mp, packed["wde"].device)
        C = kloop.forward_cluster(mp, B, M, N)
        scratch = kloop.loop_forward_scratch(mp, B, M, N, "cuda", C)
        row(kloop.forward_library(mp, M, N)[0], f"MP2018 B={B} M={M} N={N}",
            lambda: kloop.reference_loop_forward(p, x, mp),
            {"f32": lambda: kloop._launch(packed, x, mp, False, 0.0, 0, 0, C, scratch),
             "bf16": lambda: kloop._launch(packed, x, bf16(mp), False, 0.0, 0, 0, C, scratch)},
            kloop.loop_forward_flops(mp, B, M, N),
            tensor_bytes(x.values(), weights(packed)) + 4 * (B + B * M)
            + kloop.loop_forward_bytes(mp, B, M, N), kfwd.forward_fp32_flops(mp, B, M, N),
            cluster=C)
        del x, scratch
    # #5 at one MP2018 layer and at (8, 96, 96)
    for B, M, N in ((64, 96, 32), (8, 96, 96)):
        args = layer_inputs(rng, B, M, N, 256, mp.num_head, True)
        args16 = layer_cast(args, torch.bfloat16)
        centers, idx, geometry, mask, weight, params, H, _, g_update = args
        nbytes = (tensor_bytes([centers, idx, geometry, mask], params.values())
                  + 4 * (centers.numel() + B * M * N * H + geometry.numel()))
        build = kla.library(N, 256)
        row(build, f"B={B} M={M} N={N}", lambda: kla.reference_local_attention(*args),
            {"f32": lambda: kla._launch(*args), "bf16": lambda: kla._launch(*args16)},
            kla.layer_flops(B, M, N, 256, True, geometry.shape[-1]), nbytes,
            kla.layer_fp32_flops(B, M, N, 256),
            atom_block=kla.make_plan(B, M, N, 256, H, True, kla.sm_count(centers.device))[0])
        with torch.inference_mode():
            out[build]["ms_back_to_back"] = back_to_back_ms(lambda: kla._launch(*args))
        del args, args16
    return out


def phase20_paths(qm9_model, mp2018, failures, card):
    """The main paths at D = G = O = 256 through the entry points a user
    calls, with the launch counts set to 0 just before each and read just
    after: ``Scann.predict_featurized`` of one QM9 molecule (benzene; #1's
    build, one launch), of an MP2018 crystal of 300 sites at 24 neighbours
    (ladder (384, 24): the tall #3) and one of 40 sites at 80 (ladder (48,
    96): the wide #3), then of two crystals of 40 sites (ladder (48, 24) and
    (48, 96)) to an MP2018 model without the attention LayerNorm (the
    per-layer model: L launches of the narrow #5 and L of the wide one);
    each answer held to the eager model at rtol/atol. Returns the launches
    of each *_d256 build."""
    import dataclasses

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import scann_forward

    rng = np.random.default_rng(201)
    qm9, mp = widened(qm9_model, 256, 256, 256), widened(mp2018, 256, 256, 256)
    counters = (kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention)

    def reset():
        for c in counters:
            for name in ("launches", "wide_launches", "tall_launches", "d256_launches"):
                if hasattr(c, name):
                    setattr(c, name, 0)

    def model(cfm, target):
        hyper = HyperConfig(batch_size=16, target=target, target_mean=-0.2, target_std=0.03)
        scann = Scann(ScannConfig(model=cfm, hyper=hyper, tpu=TpuConfig(max_buckets=2)),
                      device="cuda")
        scann.init_params(0)
        return scann

    def record(na, nmax):
        x = wide_batch(rng, 1, na, nmax, mp, min_atoms=na, edges=False)
        return {k: v.cpu().numpy() for k, v in x.items()}

    def held(label, scann, structs, inputs, answers):
        for (pred, ga), x, st in zip(answers, inputs, structs):
            with torch.inference_mode():
                want, _ = scann_forward(scann.params, {k: torch.from_numpy(v).cuda()
                                                       for k, v in x.items()},
                                        scann.config.model)
            hyper = scann.config.hyper
            want = want[0, 0].item() * hyper.target_std + hyper.target_mean
            ok = abs(pred - want) <= ATOL + RTOL * abs(want) and len(ga) == len(st)
            print(f"phase 20 served {label} ({len(st)} sites): {pred:.6f}, the eager model "
                  f"{want:.6f}", flush=True)
            if not ok or not np.isfinite(ga).all():
                failures.append(f"phase 20 served {label}: {pred} against the eager model's "
                                f"{want}")

    launched = {}
    # one QM9 molecule: #1's *_d256 build
    qscann = model(qm9, "homo")
    sp, xyz = MOLECULES["benzene"]
    structs = [Structure(sp, xyz)]
    _, inputs = qscann.featurize_structures(structs)
    inputs = [{k: np.asarray(v) for k, v in inputs[0].items()}]
    reset()
    answers = qscann.predict_featurized(structs, inputs)
    torch.cuda.synchronize()
    c1 = kfwd.fused_scann_forward
    launched["scann_forward_d256"] = c1.d256_launches
    route = qscann.trainer.eval_route(inputs[0]["atomic"].shape[1],
                                      inputs[0]["neighbors"].shape[2])
    print(f"phase 20 served a QM9 molecule to a D = 256 model: route {route}, #1 launches "
          f"{c1.launches} ({c1.d256_launches} of scann_forward_d256)  [{card}]", flush=True)
    if route != "fused" or c1.launches != 1 or c1.d256_launches != 1:
        failures.append(f"phase 20 QM9 molecule: route {route}, #1 launches {c1.launches} "
                        f"({c1.d256_launches} d256)")
    held("QM9 molecule", qscann, structs, inputs, answers)
    del qscann
    # two MP2018 crystals: #3's tall and wide *_d256 builds
    mscann = model(mp, "formation_energy_per_atom")
    structs = [Structure(["Si"] * na, rng.uniform(0, 9, size=(na, 3)), np.eye(3) * 9.0)
               for na in (300, 40)]
    inputs = [record(300, 24), record(40, 80)]
    reset()
    answers = mscann.predict_featurized(structs, inputs, batch_size=4)
    torch.cuda.synchronize()
    c3 = kloop.launch_loop_forward
    launched["scann_loop_tall_d256"] = c3.tall_launches
    launched["scann_loop_wide_d256"] = c3.wide_launches
    routes = [mscann.trainer.eval_route(384, 24), mscann.trainer.eval_route(48, 96)]
    print(f"phase 20 served MP2018 crystals of 300 and 40 sites to a D = 256 model: routes "
          f"{routes}, #3 launches {c3.launches} ({c3.d256_launches} d256: {c3.tall_launches} "
          f"tall, {c3.wide_launches} wide), #1 {c1.launches}  [{card}]", flush=True)
    if (routes != ["loop", "loop"] or (c3.launches, c3.d256_launches, c3.tall_launches,
                                       c3.wide_launches) != (2, 2, 1, 1) or c1.launches):
        failures.append(f"phase 20 crystals: routes {routes}, #3 launches {c3.launches} "
                        f"({c3.d256_launches} d256, {c3.tall_launches} tall, "
                        f"{c3.wide_launches} wide)")
    held("MP2018 crystal", mscann, structs, inputs, answers)
    del mscann
    # the per-layer route: #5's narrow and wide *_d256 builds, L launches each
    layered = model(dataclasses.replace(mp, use_attn_norm=False), "formation_energy_per_atom")
    structs = [Structure(["Si"] * 40, rng.uniform(0, 9, size=(40, 3)), np.eye(3) * 9.0)
               for _ in range(2)]
    inputs = [record(40, 24), record(40, 80)]
    reset()
    answers = layered.predict_featurized(structs, inputs, batch_size=4)
    torch.cuda.synchronize()
    c5, L = kla.fused_local_attention, mp.n_attention
    launched["local_attention_wide_d256"] = c5.wide_launches
    launched["local_attention_d256"] = c5.d256_launches - c5.wide_launches
    routes = [layered.trainer.eval_route(48, 24), layered.trainer.eval_route(48, 96)]
    print(f"phase 20 served two crystals of 40 sites to a D = 256 model without the attention "
          f"LayerNorm: routes {routes}, #5 launches {c5.launches} ({c5.d256_launches} d256, "
          f"{c5.wide_launches} wide), #3 {c3.launches}  [{card}]", flush=True)
    if (routes != ["per_layer", "per_layer"] or c3.launches
            or (c5.launches, c5.d256_launches, c5.wide_launches) != (2 * L, 2 * L, L)):
        failures.append(f"phase 20 per-layer: routes {routes}, #5 launches {c5.launches} "
                        f"({c5.d256_launches} d256, {c5.wide_launches} wide); want {2 * L}, "
                        f"{2 * L}, {L}")
    held("per-layer crystal", layered, structs, inputs, answers)
    reset()
    return launched

def phase20_backward_holds(qm9_model, mp2018, failures):
    """#4's f32 *_d256 builds against their plain versions at (D, G, O) =
    (136, 132, 140) and (256, 256, 256), dropout 0.1 with attention dropout:
    the tall build at QM9 (8, 32, 16), MP2018 (4, 96, 32) and a QM9 batch
    packed at capacity 48 (S = 8, empty segments), the wide build at MP2018
    (3, 40, 48) and (2, 24, 80) (at D = 256 two and three sub-chunks of 32
    rows; at D = 136 one sub-chunk of 64 and 64 + 16), and at D = 136 (2,
    30, 64) and (2, 30, 65) (one sub-chunk of exactly 64 rows, and 64 + 1),
    each at C = 1, 2, 4 and the rule's C (``backward_cluster``: 8 for these
    few structures) in its three schedules
    (``hold_wide_backward``: the f32 stash against the plain gradients by
    name within 1e-4 x each one's max, recompute bit-equal to it, the bf16
    stash against its plain version, relaunches on NaN- and constant-filled
    scratch bit for bit); and QM9 (8, 32, 16) in one-shot and cotangent
    mode through the public entry points (``hold_loop_backward``). Returns
    {build: worst f32 error}. The bf16 builds are held in
    ``phase20_holds``."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(203)
    worst = {}
    for D, G, O in D256_WIDTHS:
        qm9 = dataclasses.replace(widened(qm9_model, D, G, O), use_drop=True)
        mp = dataclasses.replace(widened(mp2018, D, G, O), use_drop=True)
        cases = (("QM9", qm9, synthetic_batch(rng, 8, 32, 16)),
                 ("MP2018", mp, synthetic_batch(rng, 4, 96, 32, n_atoms=mp.n_atoms,
                                                min_atoms=20)),
                 ("QM9 packed", qm9, pack_batch(synthetic_batch(rng, 24, 16, 16), 48)),
                 ("MP2018", mp, wide_batch(rng, 3, 40, 48, mp)),
                 ("MP2018", mp, wide_batch(rng, 2, 24, 80, mp)))
        if D < 256:
            cases += (("MP2018", mp, wide_batch(rng, 2, 30, 64, mp)),
                      ("MP2018", mp, wide_batch(rng, 2, 30, 65, mp)))
        for name, cfm, x in cases:
            B, M = x["atom_mask"].shape[:2]
            N, S = x["neighbors"].shape[2], kfwd.segment_count(x)
            build = kloop.backward_library(cfm, M, N, S)
            if not build.endswith("_d256"):
                raise AssertionError(f"phase 20: {name} {(B, M, N, S)} takes {build}")
            p = init_params(cfm, torch.Generator().manual_seed(23), "cuda")
            y = torch.from_numpy(rng.normal(size=(B, max(S, 1))).astype(np.float32)).cuda()
            rule = kloop.backward_cluster(cfm, B, M, N, S)
            sub = (f" sub-chunk {kloop.wide_sub_chunk(cfm, M, N, S)}"
                   if kloop.is_wide_backward(cfm, N) else "")
            err = hold_wide_backward(f"phase 20 #4 ({build}) D={D} G={G} O={O} {name}{sub}", cfm,
                                     p, x, y, 0.1, 7, failures,
                                     clusters=tuple(sorted({1, 2, 4, rule})))
            worst[build] = max(worst.get(build, 0.0), err)
            if name == "QM9":
                ct = (torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda(),
                      torch.from_numpy(rng.normal(size=(B, M, 1)).astype(np.float32)).cuda())
                err = hold_loop_backward(f"phase 20 #4 ({build}) D={D} entry points", cfm, p, x,
                                         y, False, 0.1, 7, failures, ct=ct)
                worst[build] = max(worst[build], err)
            del x
    return worst


def time_d256_turns(build, name, cfm, x, card, bf16=False):
    """#4's d256 build at one batch shape (dropout 0.1, one-shot): the f32
    stash, the recompute schedule and (``bf16``) the bf16 build with its
    schedule, all in one set of turns with the plain f32 (and bf16)
    versions: plain, kernels, kernels in the reverse order, plain (2 plain
    and 5 kernel calls a round, one warm-up call each), against the bound
    of ``loop_backward_flops``. Returns the f32 stash's row (with the
    recompute schedule's times beside it) and the bf16 build's row (or
    None)."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    params = init_params(cfm, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(params, cfm)
    B, M = x["atom_mask"].shape[:2]
    N = x["neighbors"].shape[2]
    y = torch.from_numpy(np.random.default_rng(B).normal(size=(B, 1)).astype(np.float32)).cuda()
    cfm16 = dataclasses.replace(cfm, dtype="bfloat16")
    mode16 = kloop.loop_stash_mode(cfm16, B, M, N)
    modes = {"f32": (cfm, "f32"), "recompute": (cfm, None)}
    if bf16:
        modes["bf16"] = (cfm16, mode16)
    scratch = {k: kloop.loop_backward_scratch(packed, c, B, M, N, stash=m)
               for k, (c, m) in modes.items()}
    run = {k: (lambda k=k, c=c, m=m: kloop._launch_backward(packed, x, c, y, None, True, False,
                                                            0.1, 7, 0, scratch[k], stash=m))
           for k, (c, m) in modes.items()}
    plain = {"f32": lambda: kloop.reference_loop_train_grads(params, x, y, cfm, False, 0.1, 7)}
    if bf16:
        plain["bf16"] = lambda: kloop.reference_loop_train_grads(params, x, y, cfm16, False, 0.1,
                                                                 7)
    for fn in list(plain.values()) + list(run.values()):
        fn()
    torch.cuda.synchronize()
    kt, pt = {k: [] for k in run}, {k: [] for k in plain}
    for k in plain:
        pt[k] += cuda_times(plain[k], 2, warmup=0)
    for k in list(run) + list(run)[::-1]:
        kt[k] += cuda_times(run[k], 5, warmup=0)
    for k in list(plain)[::-1]:
        pt[k] += cuda_times(plain[k], 2, warmup=0)
    del scratch
    ms = {k: statistics.median(v) for k, v in kt.items()}
    plain_ms = {k: statistics.median(v) for k, v in pt.items()}
    flops = kloop.loop_backward_flops(cfm, B, M, N)
    _, P = kbwd.grad_layout(packed)
    nbytes = tensor_bytes(x.values(), weights(packed)) + 4 * B + 4 * (P + B)
    bound, by, measured = bound_ms(flops, nbytes, kbwd.backward_fp32_flops(cfm, B, M, N))
    for k in ("f32", "recompute"):
        print(f"scann_loop_backward ({build}) at {name} B={B} M={M} N={N} L={cfm.n_attention} "
              f"({'the f32 stash' if k == 'f32' else 'the recompute schedule'}, C="
              f"{kloop.backward_cluster(cfm, B, M, N)}; dropout 0.1, one-shot; timed in turns "
              f"with the plain version): kernel {ms[k]:.4f} ms, plain {plain_ms['f32']:.4f} ms, "
              f"{flops:.4e} FLOP, bound {bound:.4f} ms by {by} ({100 * bound / ms[k]:.1f}% of it "
              f"reached)  [{card}]", flush=True)
    row = {"ms": ms["f32"], "plain_ms": plain_ms["f32"], "bound_ms": bound, "bound_by": by,
           "measured_bound_ms": measured, "flops": flops, "schedule": "f32",
           "recompute_ms": ms["recompute"], "recompute_plain_ms": plain_ms["f32"],
           "shape": [B, M, N]}
    if not bf16:
        return row, None
    b16 = kloop.backward_library(cfm16, M, N)
    bound16, by16, measured16 = bound_ms(flops, nbytes, kbwd.backward_fp32_flops(cfm, B, M, N),
                                         bf16=True)
    print(f"scann_loop_backward ({b16}) at {name} B={B} M={M} N={N} (the "
          f"{mode16 or 'recompute'} schedule; dropout 0.1, one-shot): kernel {ms['bf16']:.4f} ms, "
          f"plain {plain_ms['bf16']:.4f} ms (in turns), beside f32 {ms['bf16']:.4f} / "
          f"{ms['f32']:.4f} ms (bf16 / f32 in turns), {flops:.4e} FLOP, bound {bound16:.4f} ms "
          f"by {by16} ({100 * bound16 / ms['bf16']:.1f}% of it reached)  [{card}]", flush=True)
    return row, {"ms": ms["bf16"], "plain_ms": plain_ms["bf16"], "bound_ms": bound16,
                 "bound_by": by16, "measured_bound_ms": measured16, "flops": flops,
                 "schedule": mode16 or "recompute", "shape": [B, M, N], "bf16_ms": ms["bf16"],
                 "bf16_f32_ms": ms["f32"]}


def phase20_backward_times(qm9_model, mp2018, card):
    """#4's *_d256 builds at D = G = O = 256, each alone, at the launch's own
    cluster size (``backward_cluster``): the f32 stash and the recompute
    schedule in turns with the plain version (``time_d256_turns``) at QM9
    (128, 32, 16) and MP2018 (64, 96, 32) (the tall build) and MP2018 (16,
    80, 96) (the wide one), against the bound of ``loop_backward_flops``;
    the bf16 builds at MP2018 (64, 96, 32) and (16, 80, 96) in the same
    turns, beside their bf16 plain version and the f32 build. Returns
    {build: timing}."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_loop as kloop

    rng = np.random.default_rng(204)
    qm9, mp = widened(qm9_model, 256, 256, 256), widened(mp2018, 256, 256, 256)
    out = {}
    for name, cfm, x in (
            ("QM9 D=256", qm9, synthetic_batch(rng, 128, 32, 16)),
            ("MP2018 D=256", mp, synthetic_batch(rng, 64, 96, 32, n_atoms=mp.n_atoms,
                                                 min_atoms=20)),
            ("MP2018 D=256", mp, wide_batch(rng, 16, 80, 96, mp))):
        M = x["atom_mask"].shape[1]
        N = x["neighbors"].shape[2]
        build = kloop.backward_library(cfm, M, N)
        t, t16 = time_d256_turns(build, name, cfm, x, card, bf16=name.startswith("MP2018"))
        if build in out:       # the MP2018 bucket's row, with the QM9 bucket's beside it
            t = dict(t, qm9=out[build])
        out[build] = t
        if t16 is not None:
            out[kloop.backward_library(dataclasses.replace(cfm, dtype="bfloat16"), M, N)] = t16
        del x
    return out


def phase20_train(qm9_model, mp2018, failures, card):
    """The training path at D = G = O = 256 through the entry points a user
    calls: ``Trainer.fit`` for 3 epochs of a QM9 model in a (32, 16) bucket
    and of an MP2018 model, f32 and bf16, in a (96, 32) and a (48, 96)
    bucket (32 seeded structures each, batch 16, the recipes' learning
    rate), with the launch counts set to 0 just before and read just after:
    every step must take the "loop" route, one launch of #4's d256 build a
    step (the tall build at (32, 16) and (96, 32), the wide one at (48, 96);
    ``.d256_launches`` equal to the steps, no #2 launch), with finite epoch
    losses, the last lower than the first; the same f32 epochs with the
    plain step (``plain_loop_trainer``) must give the same losses and
    validation MAEs within ``TRAIN_RTOL``. Returns the launches of each #4
    d256 build."""
    import dataclasses
    import tempfile

    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.pipeline import PackedBucket
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(205)
    work = tempfile.mkdtemp(prefix="scann_chip_smoke_d256_")
    qm9, mp = widened(qm9_model, 256, 256, 256), widened(mp2018, 256, 256, 256)
    launched = {}

    def bucket(cfm, n, M, N):
        x = (synthetic_batch(rng, n, M, N, n_atoms=cfm.n_atoms) if N <= 32
             else wide_batch(rng, n, M, N, cfm))
        x = {k: v.cpu().numpy() for k, v in x.items()}
        return PackedBucket(x, rng.normal(size=n).astype(np.float32), np.arange(n))

    for label, cfm, shapes in (("QM9", qm9, ((32, 16),)),
                               ("MP2018", mp, ((96, 32), (48, 96))),
                               ("bf16 MP2018", dataclasses.replace(mp, dtype="bfloat16"),
                                ((96, 32), (48, 96)))):
        cfg = ScannConfig(model=cfm,
                          hyper=HyperConfig(batch_size=16, scheduler="sgdr", lr=5e-4,
                                            min_lr=1e-4, epochs=3, seed=0,
                                            save_path=os.path.join(work, label)),
                          tpu=TpuConfig(max_buckets=2))
        train = [bucket(cfm, 32, M, N) for M, N in shapes]
        valid = [bucket(cfm, 16, M, N) for M, N in shapes]
        trainer = Trainer(cfg, device="cuda", workdir=os.path.join(work, label, "fit"))
        trainer.init_state(0)
        routes = [trainer.train_route(*b.shape) for b in train]
        builds = [kloop.backward_library(cfm, *b.shape) for b in train]
        c4 = kloop.launch_loop_backward
        kbwd.reset_counts(c4)
        kbwd.reset_counts(kbwd.launch_scann_backward)
        t0 = time.time()
        hist = trainer.fit(train, valid, epochs=3, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.time() - t0
        steps = [3 * -(-b.num_structures // 16) for b in train]
        tall = sum(s for s, b in zip(steps, train) if b.shape[1] <= 32)
        print(f"phase 20 trained a {label} model at D = 256 for 3 epochs in buckets "
              f"{[b.shape for b in train]} (routes {routes}, builds {builds}) in {wall:.1f} s: "
              f"{sum(steps)} steps, #4 launches {c4.launches} ({c4.d256_launches} d256: "
              f"{c4.tall_launches} tall, {c4.wide_launches} wide; {mode_counts(c4)}), #2 "
              f"{kbwd.launch_scann_backward.launches}; losses "
              f"{[round(v, 5) for v in hist['loss']]}  [{card}]", flush=True)
        if (set(routes) != {"loop"} or c4.launches != sum(steps)
                or c4.d256_launches != sum(steps) or c4.tall_launches != tall
                or c4.wide_launches != sum(steps) - tall or kbwd.launch_scann_backward.launches):
            failures.append(f"phase 20 {label} training: routes {routes}, #4 launches "
                            f"{c4.launches} ({c4.d256_launches} d256, {c4.tall_launches} tall, "
                            f"{c4.wide_launches} wide) for {sum(steps)} steps ({tall} tall), "
                            f"#2 {kbwd.launch_scann_backward.launches}")
        if not (all(np.isfinite(hist["loss"])) and hist["loss"][-1] < hist["loss"][0]):
            failures.append(f"phase 20 {label} training: losses {hist['loss']}")
        if cfm.dtype == "float32":
            plain = plain_loop_trainer()(cfg, "cuda", os.path.join(work, label, "plain"))
            plain.init_state(0)
            ref = plain.fit(train, valid, epochs=3, log_fn=lambda *a: None)
            mine, want = hist["loss"] + hist["val_mae"], ref["loss"] + ref["val_mae"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(mine, want))
            print(f"phase 20 {label}: the same epochs with the plain step: losses "
                  f"{[round(v, 5) for v in ref['loss']]}; max rel {rel:.3e} from the kernel's "
                  f"(limit {TRAIN_RTOL})", flush=True)
            if not rel <= TRAIN_RTOL:
                failures.append(f"phase 20 {label}: kernel and plain epochs differ by {rel:.3e}")
            del plain
        for name, n in ((kloop.backward_library(cfm, 96, 32), c4.tall_launches),
                        (kloop.backward_library(cfm, 48, 96), c4.wide_launches)):
            launched[name] = launched.get(name, 0) + n
        kbwd.reset_counts(c4)
        del trainer
    return launched


def phase20(qm9_model, mp2018, failures, card):
    """Phase 20: widths above 128. Returns the kernels line's rows of the nine
    *_d256 builds (#1, the tall and wide #3, the narrow and wide #5, and the
    tall and wide #4 in f32 and bf16)."""
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    t0 = time.time()
    worst, worst16 = phase20_holds(qm9_model, mp2018, failures)
    worst.update(phase20_backward_holds(qm9_model, mp2018, failures))
    t1 = time.time()
    times = phase20_times(qm9_model, mp2018, card)
    times.update(phase20_backward_times(qm9_model, mp2018, card))
    t2 = time.time()
    launched = phase20_paths(qm9_model, mp2018, failures, card)
    launched.update(phase20_train(qm9_model, mp2018, failures, card))
    print(f"phase 20 wall (s): holds {t1 - t0:.1f}, times {t2 - t1:.1f}, main paths "
          f"{time.time() - t2:.1f}", flush=True)
    rows = []
    for name, replaces in (("scann_forward_d256", kfwd.REPLACES),
                           ("scann_loop_tall_d256", kloop.REPLACES),
                           ("scann_loop_wide_d256", kloop.REPLACES),
                           ("local_attention_d256", kla.REPLACES),
                           ("local_attention_wide_d256", kla.REPLACES)):
        rows.append({"name": name, "route": "cuda",
                     "source": f"scann_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                     "launches": launched[name], "max_abs_err": worst[name],
                     "bf16_max_abs_err": worst16[name], "library_ms": None, **times[name]})
    # #4's d256 builds: the f32 rows held by phase20_backward_holds, the bf16
    # ones by phase20_holds (the max abs error of the recompute schedule and
    # the bf16 stash against their bf16 plain versions)
    for name in ("scann_loop_backward_tall_d256", "scann_loop_backward_wide_d256",
                 "scann_loop_backward_tall_d256_bf16", "scann_loop_backward_wide_d256_bf16"):
        err = worst16[name] if name.endswith("_bf16") else worst[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"scann_tpu_torch/csrc/{name}.cu",
                     "replaces": kloop.BACKWARD_REPLACES, "launches": launched[name],
                     "max_abs_err": err, "library_ms": None, **times[name]})
    return rows


# ---- phase 21: the user's scripts (examples_torch/) on the card ---------------------------


def load_example(name):
    """``examples_torch/<name>.py`` as the module ``examples_torch_<name>``:
    ``examples/`` holds the JAX scripts under the same names."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples_torch",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def subset_dataset(info, n, out_dir, seed):
    """``n`` molecules of phase 5's featurized set, drawn across its size
    range (the set is sorted by size), written as a dataset pair of their
    own: nothing is featurized again."""
    energy, nbr = info["data"]
    records, neighbors = (np.load(f, allow_pickle=True) for f in (energy, nbr))
    pick = np.sort(np.random.default_rng(seed).choice(len(records), n, replace=False))
    os.makedirs(out_dir, exist_ok=True)
    paths = (os.path.join(out_dir, "synthetic_data_energy.npy"),
             os.path.join(out_dir, "synthetic_data_neighbor_dt4.0_wt0.4.npy"))
    for path, data in zip(paths, (records, neighbors)):
        np.save(path, data[pick])
    return paths


def csv_rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split(",") for line in f]


def same_csv(got, want):
    """Where two of ``ga_analysis``'s CSVs differ: the header, the row
    count, a cell that is "nan" (an element the structure lacks) in one
    only, or a number more than rtol 1e-4 / atol 1e-5 plus one unit of its
    last printed digit apart (both sides are rounded); [] when they agree."""
    if got[0] != want[0] or len(got) != len(want):
        return [f"header or rows: {got[0]} x {len(got)} against {want[0]} x {len(want)}"]
    bad = []
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(want[0], g_row, w_row):
            if "nan" in (g, w) or col == "structure":
                if g != w:
                    bad.append(f"row {w_row[0]} {col}: {g} against {w}")
                continue
            unit = 10.0 ** -len(w.split(".")[1])
            if not (np.isfinite(float(g))
                    and abs(float(g) - float(w)) <= ATOL + RTOL * abs(float(w)) + unit):
                bad.append(f"row {w_row[0]} {col}: {g} against {w}")
    return bad


def phase21(qm9_model, qm9_run, failures, card):
    """Phase 21: the user's scripts (``examples_torch/``) on the card,
    through their own entry points, on phase 5's molecules. One short run
    trains the QM9 recipe's model (1 epoch, 256 molecules) on the card;
    ``interpretability.main`` predicts two xyz molecules from its run
    directory on the card and again on the CPU (values and GA scores at the
    forward tolerance, each GA vector summing to 1); ``ga_analysis.main``
    runs over that run's whole dataset on the card and on the CPU (the
    arrays at the forward tolerance, the CSVs row for row);
    ``packed_training.run_once`` trains the demo's model 2 epochs on 512
    molecules bucketed, then packed (packed occupancy above bucketed).
    The launch counts are set to 0 before and read after each script on
    the card, and the routes the Trainer picked are recorded: #1 and #2
    must launch (#2 on packed slots in the packed run), #3-#5 never, and no
    batch may take the per-layer route. Returns the launches by kernel (the
    backward kernels' also by schedule)."""
    import contextlib

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.train.loop import Trainer

    t0 = time.time()
    work = os.path.join(qm9_run["work"], "phase21")
    counters = {"scann_forward": kfwd.fused_scann_forward,
                "scann_backward": kbwd.launch_scann_backward,
                "scann_loop": kloop.launch_loop_forward,
                "scann_loop_backward": kloop.launch_loop_backward,
                "local_attention": kla.fused_local_attention}

    def reset():
        for c in counters.values():
            c.launches = 0
        for name in ("scann_backward", "scann_loop_backward"):
            kbwd.reset_counts(counters[name])

    def read():
        return {**{k: c.launches for k, c in counters.items()},
                **{f"{k}/{m}": n for k in ("scann_backward", "scann_loop_backward")
                   for m, n in schedules(counters[k]).items()}}

    routes = []

    def recorded(kind, method):
        def route(self, M, N, S=0):
            out = method(self, M, N, S)
            routes.append((kind, out, S))
            return out
        return route

    runs, total = {}, {}

    @contextlib.contextmanager
    def counted(name):
        """Launches and routes of one script's run on the card."""
        reset()
        del routes[:]
        t = time.time()
        yield
        torch.cuda.synchronize()
        runs[name] = {"launches": read(), "routes": list(routes), "s": time.time() - t}
        for k, v in runs[name]["launches"].items():
            total[k] = total.get(k, 0) + v

    original = Trainer.eval_route, Trainer.train_route
    Trainer.eval_route = recorded("eval", original[0])
    Trainer.train_route = recorded("train", original[1])
    try:
        # ---- one short training run on the card, whose run directory the two
        # ---- analysis scripts read
        energy, nbr = subset_dataset(qm9_run, 256, os.path.join(work, "data256"), 21)
        cfg = ScannConfig(model=qm9_model,
                          hyper=HyperConfig(batch_size=128, scheduler="sgdr", lr=5e-4,
                                            min_lr=1e-4, data_energy_path=energy,
                                            data_nei_path=nbr, epochs=1, seed=0,
                                            save_path=os.path.join(work, "run")),
                          tpu=TpuConfig(max_buckets=2))
        with counted("train"):
            scann = Scann(cfg, device="cuda")
            scann.prepare_dataset()
            scann.train()
        run_dir = scann.trainer.workdir

        # ---- interpretability: two molecules, on the card, then the CPU
        interp = load_example("interpretability")
        xyz = []
        for name in ("water", "benzene"):
            species, coords = MOLECULES[name]
            path = os.path.join(work, f"{name}.xyz")
            Structure(species, coords).to_xyz(path)
            xyz.append(path)
        with counted("interpretability"):
            on_card = interp.main(["--model-dir", run_dir, "--out", os.path.join(work, "ga_card"),
                                   "--device", "cuda", *xyz])
        on_cpu = interp.main(["--model-dir", run_dir, "--out", os.path.join(work, "ga_cpu"),
                              "--device", "cpu", *xyz])
        for name in on_cpu:
            (v, ga), (v0, ga0) = on_card[name], on_cpu[name]
            ok = (np.isfinite(v) and abs(v - v0) <= ATOL + RTOL * abs(v0)
                  and ga.shape == ga0.shape and np.all(np.abs(ga - ga0) <= ATOL + RTOL * np.abs(ga0))
                  and abs(ga.sum() - 1) <= 1e-5 and abs(ga0.sum() - 1) <= 1e-5)
            print(f"phase 21 interpretability {name}: card {v:.6f}, CPU {v0:.6f}, GA max |d| "
                  f"{float(np.abs(ga - ga0).max()):.3e}, GA sums {ga.sum():.7f} and "
                  f"{ga0.sum():.7f} (rtol {RTOL}, atol {ATOL})", flush=True)
            if not ok:
                failures.append(f"phase 21 interpretability {name}: the card's {v}, {ga} against "
                                f"the CPU's {v0}, {ga0}")

        # ---- ga_analysis over the run's dataset, on the card, then the CPU
        ga_script = load_example("ga_analysis")
        csvs = [os.path.join(work, f"ga_{d}.csv") for d in ("card", "cpu")]
        with counted("ga_analysis"):
            preds, gas = ga_script.main([run_dir, "--out", csvs[0], "--device", "cuda"])
        preds0, gas0 = ga_script.main([run_dir, "--out", csvs[1], "--device", "cpu"])
        rows, rows0 = csv_rows(csvs[0]), csv_rows(csvs[1])
        d_pred = float(np.abs(preds - preds0).max())
        d_ga = max(float(np.abs(g - g0).max()) for g, g0 in zip(gas, gas0))
        bad = same_csv(rows, rows0)
        ok = (len(rows) == 1 + 256 and preds.shape == preds0.shape == (256,)
              and np.isfinite(preds).all()
              and np.all(np.abs(preds - preds0) <= ATOL + RTOL * np.abs(preds0))
              and all(g.shape == g0.shape and np.all(np.abs(g - g0) <= ATOL + RTOL * np.abs(g0))
                      for g, g0 in zip(gas, gas0)) and not bad)
        print(f"phase 21 ga_analysis: {len(rows) - 1} rows of {len(rows[0])} columns; card "
              f"against CPU: predictions max |d| {d_pred:.3e}, GA {d_ga:.3e} (rtol {RTOL}, atol "
              f"{ATOL}); CSV cells apart {len(bad)}", flush=True)
        if not ok:
            failures.append(f"phase 21 ga_analysis: card against CPU {d_pred:.3e}, {d_ga:.3e}, "
                            f"{len(rows)} rows, CSV {bad[:4]}")

        # ---- packed_training: the demo's model, bucketed then packed. At this
        # ---- size host time decides the epoch: its seconds and structures/s
        # ---- say nothing of packing's speed (phase 5's packed run does)
        packed = load_example("packed_training")
        energy, nbr = subset_dataset(qm9_run, 512, os.path.join(work, "data512"), 22)
        demo = {}
        for name, packing in (("bucketed", False), ("packed", True)):
            with counted(name):
                demo[name] = packed.run_once(os.path.join(work, name), energy, nbr, 2, packing,
                                             device="cuda")
            r = demo[name]
            print(f"phase 21 packed_training {name}: occupancy {r['occupancy']:.4f}, epoch "
                  f"{r['epoch_s']:.4f} s, {r['structs_per_sec']:.1f} structures/s, slot batch "
                  f"{r['slot_batch']}, val_mae {r['val_mae']:.4f} (host-bound at this size: no "
                  f"measure of packing's speed)  [{card}]", flush=True)
            if not (np.isfinite(r["val_mae"]) and np.isfinite(r["preds"]).all()
                    and r["preds"].shape == (512,)):
                failures.append(f"phase 21 packed_training {name}: not finite: {r['val_mae']}")
        if not demo["packed"]["occupancy"] > demo["bucketed"]["occupancy"]:
            failures.append(f"phase 21 packed_training: packed occupancy "
                            f"{demo['packed']['occupancy']} not above bucketed "
                            f"{demo['bucketed']['occupancy']}")
    finally:
        Trainer.eval_route, Trainer.train_route = original

    # ---- what each run launched, and the routes it took
    for name, r in runs.items():
        n = r["launches"]
        took = sorted({(kind, route, S > 0) for kind, route, S in r["routes"]})
        print(f"phase 21 {name}: {r['s']:.2f} s; #1 {n['scann_forward']}, #2 "
              f"{n['scann_backward']} ({n['scann_backward/f32']} f32 stash), #3 "
              f"{n['scann_loop']}, #4 {n['scann_loop_backward']}, #5 {n['local_attention']}; "
              f"routes (kind, route, packed) {took}", flush=True)
        want_1 = len(xyz) if name == "interpretability" else None
        want_2 = name in ("train", "bucketed", "packed")
        if (n["scann_forward"] == 0 or (want_1 is not None and n["scann_forward"] != want_1)
                or (n["scann_backward"] > 0) != want_2 or n["scann_loop"]
                or n["scann_loop_backward"] or n["local_attention"]
                or any(route == "per_layer" for _, route, _ in r["routes"])):
            failures.append(f"phase 21 {name}: launches {n}, routes {took}")
        steps = [(route, S) for kind, route, S in r["routes"] if kind == "train"]
        if name == "packed" and not (steps and all(route == "fused" and S > 0
                                                   for route, S in steps)):
            failures.append(f"phase 21 packed: #2 not on packed slots: train routes {steps}")
    print(f"phase 21 wall: {time.time() - t0:.1f} s  [{card}]", flush=True)
    return total


# ---- phase 22: widths past 256 (D, G, O up to 512) in #1, #3, #4 and #5 -------------------

# one triple that no width class divides, and 384 and 512, where the JAX
# gates still take the QM9 buckets on #1; 8 heads as published
D512_WIDTHS = ((264, 260, 268), (384, 384, 384), (512, 512, 512))
# ``hold_layer_past_256``: an f32 #5 output past 256 columns outside
# rtol/atol of the plain version stays within this many times the f32 plain
# version's distance from the plain layer in float64
PAST_256_FACTOR = 4
D512_BUILDS = ("scann_forward_d512", "scann_loop_tall_d512", "scann_loop_wide_d512",
               "local_attention_d512", "local_attention_wide_d512")
# #4's builds past 256 columns, f32 and bf16
D512_BACKWARD_BUILDS = ("scann_loop_backward_tall_d512", "scann_loop_backward_wide_d512",
                        "scann_loop_backward_tall_d512_bf16", "scann_loop_backward_wide_d512_bf16")


def phase22_holds(qm9_model, mp2018, failures):
    """Every *_d512 build against its plain version at (D, G, O) = (264,
    260, 268), (384, 384, 384) and (512, 512, 512), f32 and bf16 (bf16 by
    ``hold_bf16`` and ``hold_bf16_shape``, phase 20's rules): #1 at QM9 (16,
    32, 16) and (8, 8, 8) of 1-8 atoms, at D = 512 also on a packed batch
    (QM9 at capacity 32, S = 8) and with dropout on, each at every size of
    ``HOLD_CLUSTERS`` the batch takes and the rule's, on NaN-filled L2 rows,
    bit for bit (``hold_fused_clusters``); #3 at MP2018 (4, 96, 16) (the
    tall build, N <= 16 past 256 columns) and (4, 80, 96) (the wide one) at
    C = 1, 2, 4 and the rule's, relaunched on NaN- and constant-filled
    scratch (``hold_loop_forward``), at D = 512 also packed (crystals of
    20-90 sites at capacity 96, the tall build), (3, 40, 48) and the
    wide build's 16-row sub-chunks at their edges, (2, 40, 17), (2, 30, 33)
    and (2, 24, 80), at every size of ``HOLD_CLUSTERS``; #5 on one layer at
    (8, 96, 16), (3, 37, 12) and (4, 40, 8) (the narrow build: one atom a
    chunk of 16 rows, a ragged last chunk, two atoms a chunk) and (8, 96,
    32), (8, 96, 96), (3, 20, 17) and (2, 32, 256) (the wide one: one row
    past a sub-chunk, the widest list), SCANN+, and SCANN at (8, 96, 16) and
    (8, 96, 96), f32 and bf16 tensors, each relaunched into NaN-filled
    outputs (``hold_layer_past_256``). Returns {build: worst f32 error} and
    {build: worst bf16 error}."""
    import dataclasses

    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(22)
    worst, worst16 = {}, {}
    note = lambda d, k, v: d.__setitem__(k, max(d.get(k, 0.0), v))
    for D, G, O in D512_WIDTHS:
        qm9, mp = widened(qm9_model, D, G, O), widened(mp2018, D, G, O)
        qm9_16 = dataclasses.replace(qm9, dtype="bfloat16")
        p = init_params(qm9, torch.Generator().manual_seed(22), "cuda")
        packed = kfwd.pack_params(p, qm9)
        lib = kfwd.library(qm9)
        cases = [("", synthetic_batch(rng, 16, 32, 16), ()),
                 ("", synthetic_batch(rng, 8, 8, 8, min_atoms=1), ())]
        if D == 512:   # each from a generator of its own
            cases += [("QM9 capacity 32", pack_batch(
                synthetic_batch(np.random.default_rng(2232), 12, 29, 16), 32), ()),
                      ("dropout 0.1", synthetic_batch(np.random.default_rng(2249), 8, 32, 16),
                       (0.1, 27, 40))]
        for label, x, drop in cases:
            B, M = x["atomic"].shape[:2]
            N = x["neighbors"].shape[2]
            tag = f"phase 22 #1 ({lib}) D={D} G={G} O={O} B={B} M={M} N={N} {label}{packed_label(x)}"
            with torch.inference_mode():
                got = (kfwd._launch(packed, x, qm9, False, *drop) if drop
                       else kfwd.fused_scann_forward(p, x, qm9))
                got16 = kfwd._launch(packed, x, qm9_16, False, *drop)
                want = kfwd.reference_scann_forward(p, x, qm9, False, *drop)
                plain16 = kfwd.reference_scann_forward(p, x, qm9_16, False, *drop)
                f64 = kfwd.reference_scann_forward(f64_params(p), x, qm9_16, False, *drop)
                moved = [kfwd.reference_scann_forward(jittered(p, j), x, qm9_16, False, *drop)
                         for j in range(JITTERS)]
                torch.cuda.synchronize()
            note(worst, lib, hold(tag, [("pred", got[0], want[0], ATOL),
                                        ("ga", got[1], want[1], ATOL)], failures))
            hold_fused_clusters(tag, packed, x, qm9, drop, got, got16, failures)
            note(worst16, lib, hold_bf16(f"{tag} bf16", got16, plain16, want, got, failures, f64,
                                         below_f32=0.9, plain16_moved=moved))
        p = init_params(mp, torch.Generator().manual_seed(22), "cuda")
        shapes = [((4, 96, 16), (1, 2, 4)), ((4, 80, 96), (1, 2, 4))]
        if D == 512:   # and the wide build's 16-row sub-chunks at their edges
            shapes += [((3, 40, 48), (1, 2, 4)), ((2, 40, 17), HOLD_CLUSTERS),
                       ((2, 30, 33), HOLD_CLUSTERS), ((2, 24, 80), HOLD_CLUSTERS)]
        for (B, M, N), clusters in shapes:
            x = (synthetic_batch(rng, B, M, N, n_atoms=mp.n_atoms, min_atoms=20) if N <= 16
                 else wide_batch(rng, B, M, N, mp))
            build = kloop.forward_library(mp, M, N)[0]
            tag = f"phase 22 #3 ({build}) D={D} G={G} O={O}"
            note(worst, build, hold_loop_forward(tag, mp, p, x, failures, clusters=clusters,
                                                 relaunches=2))
            if D == 512 and N == 16:   # packed: crystals of 20-90 sites at capacity 96
                xp = pack_batch(synthetic_batch(np.random.default_rng(2296), 12, 90, 16,
                                                n_atoms=mp.n_atoms, min_atoms=20), 96)
                note(worst, build, hold_loop_forward(f"{tag} capacity 96", mp, p, xp, failures,
                                                     clusters=clusters, relaunches=2))
                del xp
            note(worst16, build, hold_bf16_shape(f"phase 22 D={D}", mp, x, failures, below=None,
                                                 clusters3=clusters, grads=False,
                                                 jitters=JITTERS)[0])
            del x
        for g_update, (B, M, N) in ((True, (8, 96, 16)), (True, (3, 37, 12)), (True, (4, 40, 8)),
                                    (True, (8, 96, 32)), (True, (8, 96, 96)),
                                    (True, (3, 20, 17)), (True, (2, 32, 256)),
                                    (False, (8, 96, 16)), (False, (8, 96, 96))):
            args = layer_inputs(rng, B, M, N, D, mp.num_head, g_update)
            if N > 16:
                wide_masks(args[3])
            kla.check_neighbor_range(*kla.index_bounds(args[1]), M)
            build = kla.library(N, D)
            errs = hold_layer_past_256(f"phase 22 #5 ({build}) {'scann+' if g_update else 'scann'} "
                                       f"B={B} M={M} N={N} D={D}", args, failures)
            note(worst, build, errs[0])
            note(worst16, build, errs[1])
    return worst, worst16


def phase22_backward_holds(qm9_model, mp2018, failures):
    """#4's *_d512 builds against their plain versions at (D, G, O) = (264,
    260, 268) and (512, 512, 512), dropout 0.1 with attention dropout: the
    tall build (N <= 16 past 256 columns) at QM9 (4, 32, 8) (D = 264) and
    (4, 32, 16) (D = 512), the wide one at MP2018 (3, 40, 24) (D = 264) and
    (2, 24, 40) (D = 512) (two and three 16-row sub-chunks, the last
    short), at D = 512 also a QM9 batch packed at capacity 32 (S = 8, empty
    segments) and MP2018 (2, 24, 121) (atom blocks of 1), each in its three
    schedules (``hold_wide_backward``: the f32
    stash against the plain gradients by name within 1e-4 x each one's max
    and pred at rtol / atol, recompute bit-equal to it, the bf16 stash
    against its plain version, relaunches on NaN- and constant-filled
    scratch bit for bit) at C = 1, 2, 4 and the rule's C, at D = 512 (4,
    32, 16) and (2, 24, 40) at every size the builds take (1-8); and QM9 (4,
    32, 16) in one-shot and cotangent mode through the public entry points
    (``hold_loop_backward``). The bf16 builds by ``hold_bf16_shape``'s rule
    at D = 384, as phase 20 holds the d256 ones: MP2018 (4, 96, 16) (tall)
    and (3, 40, 48) (wide) in their three schedules at C = 1, 2, 4 at full
    depth, and with one layer over 16 structures at the rule's C, pred at
    0.9 x the f32 kernel's reading, the gradients at 0.5 x in the tall
    build and at 0.9 x (``hold_bf16_shape``'s default) in the wide one:
    there the f32-noise floor of the bf16 plain version is above half the
    bf16-vs-f32 gap (0.76 x it on the batch held; 0.59 x in the median of
    16 batches of the d256 build, where the 0.5 x rule failed 8 of 16 at
    every C alike while the kernel read within that floor in all 16), so
    0.5 x would fail a kernel that rounds where the plain version does.
    Returns ({build: worst f32 error}, {build: worst bf16 error})."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(2204)
    worst, worst16 = {}, {}
    note = lambda d, k, v: d.__setitem__(k, max(d.get(k, 0.0), v))
    for D, G, O in (D512_WIDTHS[0], D512_WIDTHS[-1]):
        qm9 = dataclasses.replace(widened(qm9_model, D, G, O), use_drop=True)
        mp = dataclasses.replace(widened(mp2018, D, G, O), use_drop=True)
        cases = ([("QM9", qm9, synthetic_batch(rng, 4, 32, 8)),
                  ("MP2018", mp, wide_batch(rng, 3, 40, 24, mp))] if D < 512 else
                 [("QM9", qm9, synthetic_batch(rng, 4, 32, 16)),
                  ("MP2018", mp, wide_batch(rng, 2, 24, 40, mp))])
        if D == 512:   # each from a generator of its own
            cases += [("QM9 packed", qm9, pack_batch(
                synthetic_batch(np.random.default_rng(2205), 12, 16, 16), 32)),
                      ("MP2018", mp, wide_batch(np.random.default_rng(2206), 2, 24, 121, mp))]
        for name, cfm, x in cases:
            B, M = x["atom_mask"].shape[:2]
            N, S = x["neighbors"].shape[2], kfwd.segment_count(x)
            build = kloop.backward_library(cfm, M, N, S)
            if not build.endswith("_d512"):
                raise AssertionError(f"phase 22: {name} {(B, M, N, S)} takes {build}")
            p = init_params(cfm, torch.Generator().manual_seed(22), "cuda")
            y = torch.from_numpy(rng.normal(size=(B, max(S, 1))).astype(np.float32)).cuda()
            rule = kloop.backward_cluster(cfm, B, M, N, S)
            clusters = (kloop.D256_CLUSTER_SIZES if not S and (M, N) in ((32, 16), (24, 40))
                        else tuple(sorted({1, 2, 4, rule})))
            sub = (f" sub-chunk {kloop.wide_sub_chunk(cfm, M, N, S)}"
                   if kloop.is_wide_backward(cfm, N) else "")
            note(worst, build, hold_wide_backward(
                f"phase 22 #4 ({build}) D={D} G={G} O={O} {name}{sub}", cfm, p, x, y, 0.1, 7,
                failures, clusters=tuple(sorted(clusters))))
            if name == "QM9" and N == 16:
                ct = (torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda(),
                      torch.from_numpy(rng.normal(size=(B, M, 1)).astype(np.float32)).cuda())
                note(worst, build, hold_loop_backward(f"phase 22 #4 ({build}) D={D} entry points",
                                                      cfm, p, x, y, False, 0.1, 7, failures,
                                                      ct=ct))
            del x
    mp = widened(mp2018, 384, 384, 384)
    for M, N in ((96, 16), (40, 48)):
        batch = lambda B, M=M, N=N: (
            synthetic_batch(rng, B, M, N, n_atoms=mp.n_atoms, min_atoms=20) if N <= 16
            else wide_batch(rng, B, M, N, mp))
        build4 = kloop.backward_library(dataclasses.replace(mp, dtype="bfloat16"), M, N)
        for tag, cfm, xb, below, c4 in (
                ("phase 22 D=384", mp, batch(4 if N <= 16 else 3), None, (1, 2, 4)),
                ("phase 22 D=384 L=1", dataclasses.replace(mp, n_attention=1), batch(16),
                 0.5 if N <= 16 else 0.9, (kloop.backward_cluster(mp, 16, M, N),))):
            w3, w4 = hold_bf16_shape(tag, cfm, xb, failures, below=below, clusters3=(1, 2),
                                     jitters=JITTERS, clusters=c4,
                                     below_pred=0.9 if below else None)
            note(worst16, build4, w4)
            del xb
    return worst, worst16


def phase22_backward_times(qm9_model, mp2018, card):
    """#4's *_d512 builds, each alone at the launch's own cluster size
    (``backward_cluster``): the f32 stash and the recompute schedule in
    turns with the plain version (``time_d256_turns``) at QM9 (128, 32, 16)
    at D = 512 and D = 384 (``d384``; the tall build) and MP2018 (64, 31,
    32) at D = 384 (the wide one: N > 16 past 256 columns), against the
    bound of ``loop_backward_flops``; the bf16 builds at QM9 (128, 32, 16), D
    = 512, and MP2018 (64, 31, 32), D = 384, in the same turns beside their
    bf16 plain version and the f32 build. Returns {build: timing}."""
    import dataclasses

    from scann_tpu_torch.kernels import scann_loop as kloop

    rng = np.random.default_rng(2207)
    out = {}
    for name, cfm, x, key in (
            ("QM9 D=512", widened(qm9_model, 512, 512, 512), synthetic_batch(rng, 128, 32, 16),
             None),
            ("QM9 D=384", widened(qm9_model, 384, 384, 384), synthetic_batch(rng, 128, 32, 16),
             "d384"),
            ("MP2018 D=384", widened(mp2018, 384, 384, 384),
             synthetic_batch(rng, 64, 31, 32, n_atoms=mp2018.n_atoms, min_atoms=20), None)):
        M, N = x["atom_mask"].shape[1], x["neighbors"].shape[2]
        build = kloop.backward_library(cfm, M, N)
        t, t16 = time_d256_turns(build, name, cfm, x, card, bf16=key is None)
        if key is None:
            out.setdefault(build, {}).update(t)
        else:
            out.setdefault(build, {})[key] = t
        if t16 is not None:
            out[kloop.backward_library(dataclasses.replace(cfm, dtype="bfloat16"), M, N)] = t16
        del x
    return out


def phase22_train(mp2018, failures, card):
    """The training path of a crystal model past 256 columns through the
    entry point a user calls: ``Trainer.fit`` for one epoch of an MP2018
    model at D = G = O = 384, f32 and bf16, in a (40, 16) and a (40, 32)
    bucket of 16 seeded crystals each (batch 16), with the launch counts set
    to 0 just before and read just after: every step on the "loop" route, one
    launch of #4's d512 build a step (the tall build at N = 16, the wide one
    at N = 32: N > 16 is wide past 256 columns; ``.d512_launches`` equal to
    the steps, no #2 launch), finite losses. Returns the launches of each #4
    d512 build."""
    import dataclasses
    import tempfile

    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.pipeline import PackedBucket
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(2208)
    work = tempfile.mkdtemp(prefix="scann_chip_smoke_d512_train_")
    launched = dict.fromkeys(D512_BACKWARD_BUILDS, 0)

    def bucket(cfm, n, M, N):
        x = synthetic_batch(rng, n, M, N, n_atoms=cfm.n_atoms, min_atoms=20)
        x = {k: v.cpu().numpy() for k, v in x.items()}
        return PackedBucket(x, rng.normal(size=n).astype(np.float32), np.arange(n))

    for dtype in ("float32", "bfloat16"):
        cfm = dataclasses.replace(widened(mp2018, 384, 384, 384), dtype=dtype)
        label = f"MP2018 D = 384 {dtype}"
        cfg = ScannConfig(model=cfm,
                          hyper=HyperConfig(batch_size=16, lr=5e-4, epochs=1, seed=0,
                                            save_path=os.path.join(work, dtype)),
                          tpu=TpuConfig(max_buckets=2))
        shapes = ((40, 16), (40, 32))
        train = [bucket(cfm, 16, M, N) for M, N in shapes]
        valid = [bucket(cfm, 8, M, N) for M, N in shapes]
        trainer = Trainer(cfg, device="cuda", workdir=os.path.join(work, dtype, "fit"))
        trainer.init_state(0)
        routes = [trainer.train_route(*b.shape) for b in train]
        builds = [kloop.backward_library(cfm, *b.shape) for b in train]
        c4 = kloop.launch_loop_backward
        kbwd.reset_counts(c4)
        kbwd.reset_counts(kbwd.launch_scann_backward)
        t0 = time.time()
        hist = trainer.fit(train, valid, epochs=1, log_fn=lambda *a: None)
        torch.cuda.synchronize()
        steps = len(train)
        print(f"phase 22 fitted a {label} model for one epoch in buckets "
              f"{[b.shape for b in train]} (routes {routes}, builds {builds}) in "
              f"{time.time() - t0:.1f} s: {steps} steps, #4 launches {c4.launches} "
              f"({c4.d512_launches} d512: {c4.tall_launches} tall, {c4.wide_launches} wide; "
              f"{c4.bf16_launches} bf16; {mode_counts(c4)}), #2 "
              f"{kbwd.launch_scann_backward.launches}; loss {hist['loss']}, val MAE "
              f"{hist['val_mae']}  [{card}]", flush=True)
        if (set(routes) != {"loop"} or (c4.launches, c4.d512_launches, c4.tall_launches,
                                        c4.wide_launches) != (steps, steps, 1, 1)
                or c4.bf16_launches != steps * (dtype == "bfloat16")
                or kbwd.launch_scann_backward.launches
                or not np.isfinite(hist["loss"] + hist["val_mae"]).all()):
            failures.append(f"phase 22 {label} training: routes {routes}, #4 launches "
                            f"{c4.launches} ({c4.d512_launches} d512, {c4.tall_launches} tall, "
                            f"{c4.wide_launches} wide) for {steps} steps, #2 "
                            f"{kbwd.launch_scann_backward.launches}, history {hist}")
        launched[builds[0]] += c4.tall_launches
        launched[builds[1]] += c4.wide_launches
        kbwd.reset_counts(c4)
        del trainer
    return launched


def hold_layer_past_256(tag, args, failures):
    """``hold_wide_layer`` past 256 columns. There one layer of
    ``layer_inputs`` (its kernels 0.1 x a normal draw, not scaled by the fan
    in) sums 1,536-term products whose f32 rounding alone can reach the
    forward atol of 1e-5 (D = 512: 1.86e-5 at (8, 96, 96)), so an f32 output
    outside rtol/atol of the plain version is held instead to the plain
    layer in float64: no further from it than ``PAST_256_FACTOR`` x the f32
    plain version is (a split-TF32 product term leaves out a_lo b_lo, 2^-22
    of it, where an f32 FMA rounds at 2^-24: ``csrc/scann_mma.cuh``). A
    control shows the limit tells products of less precision: the plain
    layer with single-pass TF32 products (``allow_tf32``), which must land
    outside it. Only the outputs that missed take this rule; the others
    stand held at rtol/atol (the attention of a wholly masked atom, as
    ``wide_masks`` makes, is uniform in f32, where -1e9 swamps the energies,
    and not in float64, so there no f32 version comes near the f64 layer).
    Every other check of ``hold_wide_layer`` (bf16, relaunches) stands."""
    from scann_tpu_torch.kernels import local_attention as kla

    local = []
    worst, worst16 = hold_wide_layer(tag, args, local)
    misses = [f for f in local if "outside rtol" in f]
    failures += [f for f in local if f not in misses]
    missed = {f.split(": max_abs")[0].rsplit(" ", 1)[1] for f in misses}
    if misses:
        with torch.inference_mode():
            got = kla._launch(*args)
            want = kla.reference_local_attention(*args)
            exact = kla.reference_local_attention(*layer_cast(args, torch.float64))
            was, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, True
            try:
                control = kla.reference_local_attention(*args)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = was
        for name, g, w, c, e in zip(("out", "geometry", "attn"), got, want, control, exact):
            if name not in missed:
                continue
            port, plain, tf32 = ((t.double() - e).abs().max().item() for t in (g, w, c))
            limit = PAST_256_FACTOR * plain
            print(f"{tag} {name} against the plain layer in f64: kernel {port:.3e}, f32 plain "
                  f"version {plain:.3e}, single-pass TF32 control {tf32:.3e} (limit "
                  f"{PAST_256_FACTOR} x the f32 plain version, {limit:.3e})", flush=True)
            if not port <= limit:
                failures.append(f"{tag} {name}: {port:.3e} from the f64 plain layer, more than "
                                f"{PAST_256_FACTOR} x the f32 plain version's {plain:.3e}")
            if not tf32 > limit:
                failures.append(f"{tag} {name}: the single-pass TF32 control, {tf32:.3e} from "
                                f"the f64 plain layer, is within the limit {limit:.3e}")
    return worst, worst16


def phase22_times(qm9_model, mp2018, card):
    """The *_d512 builds at D = G = O = 512, each in one set of turns with its
    plain version and its bf16 mode (``turns_ms``), against its bound: #1 at
    QM9 (128, 32, 16), at B = 1 and 16 (``b1``, ``b16``) and at D = 384
    (``d384``); the tall #3 at MP2018 (64, 96, 16) and at (16, 62, 16), the
    largest M of the JAX loop kernel's gate at MP2018, N = 16 and D = 384
    (``jax_gate``); the wide #3 at (16, 80, 96) and at the MP2018 recipe
    bucket (64, 96, 32) (``mp2018``), which past 256 columns is wide; the
    narrow #5 at one layer (64, 96, 16); the wide #5 at (8, 96, 96) and at
    one MP2018 layer (64, 96, 32) (``mp2018``). Returns {build: timing}."""
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    rng = np.random.default_rng(220)
    out = {}
    for D, B, key in ((512, 128, None), (512, 1, "b1"), (512, 16, "b16"), (384, 128, "d384")):
        qm9 = widened(qm9_model, D, D, D)
        p = init_params(qm9, torch.Generator().manual_seed(0), "cuda")
        packed = kfwd.pack_params(p, qm9)
        x = synthetic_batch(rng, B, 32, 16)
        kfwd._check_inputs(x, qm9, packed["wde"].device)
        width_row(out, "scann_forward_d512", f"QM9 B={B} M=32 N=16", D, card,
                  lambda: kfwd.reference_scann_forward(p, x, qm9),
                  lambda cfm: lambda: kfwd._launch(packed, x, cfm, False), qm9,
                  kfwd.forward_flops(qm9, B, 32, 16),
                  tensor_bytes(x.values(), weights(packed)) + 4 * (B + B * 32),
                  kfwd.forward_fp32_flops(qm9, B, 32, 16), key,
                  cluster=kfwd.forward_cluster(qm9, B, 32, 16))
        del x
    mp = widened(mp2018, 512, 512, 512)
    p = init_params(mp, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(p, mp)
    for B, M, N, key in ((64, 96, 16, None), (16, 62, 16, "jax_gate"), (16, 80, 96, None),
                         (64, 96, 32, "mp2018")):
        x = (synthetic_batch(rng, B, M, N, n_atoms=mp.n_atoms, min_atoms=20) if N <= 16
             else wide_batch(rng, B, M, N, mp))
        kfwd._check_inputs(x, mp, packed["wde"].device)
        C = kloop.forward_cluster(mp, B, M, N)
        scratch = kloop.loop_forward_scratch(mp, B, M, N, "cuda", C)
        width_row(out, kloop.forward_library(mp, M, N)[0], f"MP2018 B={B} M={M} N={N}", 512, card,
                  lambda: kloop.reference_loop_forward(p, x, mp),
                  lambda cfm: lambda: kloop._launch(packed, x, cfm, False, 0.0, 0, 0, C, scratch),
                  mp, kloop.loop_forward_flops(mp, B, M, N),
                  tensor_bytes(x.values(), weights(packed)) + 4 * (B + B * M)
                  + kloop.loop_forward_bytes(mp, B, M, N), kfwd.forward_fp32_flops(mp, B, M, N),
                  key, cluster=C)
        del x, scratch
    for B, M, N, key in ((64, 96, 16, None), (8, 96, 96, None), (64, 96, 32, "mp2018")):
        args = layer_inputs(rng, B, M, N, 512, mp.num_head, True)
        args16 = layer_cast(args, torch.bfloat16)
        centers, idx, geometry, mask, weight, params, H, _, g_update = args
        nbytes = (tensor_bytes([centers, idx, geometry, mask], params.values())
                  + 4 * (centers.numel() + B * M * N * H + geometry.numel()))
        width_row(out, kla.library(N, 512), f"B={B} M={M} N={N}", 512, card,
                  lambda: kla.reference_local_attention(*args),
                  lambda cfm: (lambda: kla._launch(*args)) if cfm is None
                  else (lambda: kla._launch(*args16)), None,
                  kla.layer_flops(B, M, N, 512, True, geometry.shape[-1]), nbytes,
                  kla.layer_fp32_flops(B, M, N, 512), key,
                  atom_block=kla.make_plan(B, M, N, 512, H, True,
                                           kla.sm_count(centers.device))[0])
        del args, args16
    return out


def width_row(out, build, what, D, card, plain, launch, cfm, flops, nbytes, fp32, key=None,
              **extra):
    """One timing of a build past 256 columns in one set of turns (plain, f32,
    bf16, bf16, f32, plain: ``turns_ms``): ``launch(cfm)`` makes the f32 call
    and ``launch(bf16 cfm)`` the bf16 one (#5: ``launch(None)`` its f32
    tensors, ``launch("bf16")`` its bf16 ones). Kept in ``out[build]`` (the
    kernels line's row) or, with ``key``, in ``out[build][key]``."""
    import dataclasses

    bf16 = dataclasses.replace(cfm, dtype="bfloat16") if cfm is not None else "bf16"
    with torch.inference_mode():
        ms, plain_ms = turns_ms(plain, {"f32": launch(cfm), "bf16": launch(bf16)})
    bound, by, measured = bound_ms(flops, nbytes, fp32)
    bound16 = bound_ms(flops, nbytes, fp32, bf16=True)[0]
    print(f"{build} at {what} D={D}{''.join(f' {k}={v}' for k, v in extra.items())} (timed in "
          f"turns: plain, f32, bf16, bf16, f32, plain): kernel {ms['f32']:.4f} ms, bf16 "
          f"{ms['bf16']:.4f} ms, plain {plain_ms:.4f} ms, {flops:.4e} FLOP, bound {bound:.4f} "
          f"ms by {by} ({100 * bound / ms['f32']:.1f}% of it reached)  [{card}]", flush=True)
    row = {"ms": ms["f32"], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
           "measured_bound_ms": measured, "flops": flops, "bf16_ms": ms["bf16"],
           "bf16_bound_ms": bound16, "D": D, **extra}
    if key is None:
        out.setdefault(build, {}).update(row)
    else:
        out.setdefault(build, {})[key] = row


def phase22_paths(qm9_model, mp2018, failures, card):
    """The main paths past 256 columns through the entry points a user calls,
    with the launch counts set to 0 just before each and read just after:
    ``Scann.predict_featurized`` to models at D = G = O = 384 and 512, f32
    and bf16, of one QM9 molecule (benzene: #1's d512 build, one launch) and
    of two MP2018 crystals, 300 sites at 16 neighbours (the tall #3) and 40
    at 80 (the wide #3; past 256 columns N > 16 is wide), with each step's
    seconds:
    each answer held to the eager model at rtol/atol (f32) or to the bf16
    plain version at JAX's bf16 bound; two crystals of 40 sites at 12 and 80
    neighbours to a D = 512 model without the attention LayerNorm (the
    per-layer model: L launches of the narrow #5 and L of the wide one);
    then ``Trainer.fit`` of a D = 384 QM9 model for one epoch (steps on the
    "loop" route, #4's tall d512 build, ``.d512_launches`` equal to #4's
    launches and to the steps; its validation batch on #1's d512 build).
    Returns the launches of each *_d512 build (#4's tall one too)."""
    import dataclasses
    import tempfile

    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.config import HyperConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.data.pipeline import PackedBucket
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import scann_forward
    from scann_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(222)
    c1, c3, c5 = kfwd.fused_scann_forward, kloop.launch_loop_forward, kla.fused_local_attention
    launched = dict.fromkeys(D512_BUILDS + D512_BACKWARD_BUILDS[:1], 0)

    def reset():
        for c in (c1, c3, c5):
            for name in ("launches", "bf16_launches", "wide_launches", "tall_launches",
                         "d256_launches", "d512_launches"):
                if hasattr(c, name):
                    setattr(c, name, 0)

    def model(cfm, target):
        hyper = HyperConfig(batch_size=16, target=target, target_mean=-0.2, target_std=0.03)
        scann = Scann(ScannConfig(model=cfm, hyper=hyper, tpu=TpuConfig(max_buckets=2)),
                      device="cuda")
        scann.init_params(0)
        return scann

    def record(na, nmax):
        mp = widened(mp2018, 512, 512, 512)
        x = wide_batch(rng, 1, na, nmax, mp, min_atoms=na, edges=False)
        return {k: v.cpu().numpy() for k, v in x.items()}

    def held(label, scann, structs, inputs, answers, routes):
        cfm, hyper = scann.config.model, scann.config.hyper
        for (pred, ga), x, st, route in zip(answers, inputs, structs, routes):
            xt = {k: torch.from_numpy(v).cuda() for k, v in x.items()}
            with torch.inference_mode():
                if cfm.dtype == "float32":
                    want = scann_forward(scann.params, xt, cfm)[0]
                elif route == "fused":
                    want = kfwd.reference_scann_forward(scann.params, xt, cfm)[0]
                elif route == "loop":
                    want = kloop.reference_loop_forward(scann.params, xt, cfm)[0]
                else:
                    want = scann_forward(scann.params, xt, cfm)[0]
            want = want[0, 0].item() * hyper.target_std + hyper.target_mean
            rtol, atol = (RTOL, ATOL) if cfm.dtype == "float32" else (BF16_RTOL, BF16_ATOL)
            ok = abs(pred - want) <= atol + rtol * abs(want) and len(ga) == len(st)
            print(f"phase 22 served {label} ({len(st)} sites, route {route}): {pred:.6f}, "
                  f"{'the eager model' if cfm.dtype == 'float32' else 'the bf16 plain version'}"
                  f" {want:.6f}", flush=True)
            if not ok or not np.isfinite(ga).all():
                failures.append(f"phase 22 served {label}: {pred} against {want}")

    molecule = [Structure(*MOLECULES["benzene"])]
    crystals = [Structure(["Si"] * na, rng.uniform(0, 9, size=(na, 3)), np.eye(3) * 9.0)
                for na in (300, 40)]
    crystal_inputs = [record(300, 16), record(40, 80)]
    for D in (384, 512):
        for dtype in ("float32", "bfloat16"):
            qm9 = dataclasses.replace(widened(qm9_model, D, D, D), dtype=dtype)
            mp = dataclasses.replace(widened(mp2018, D, D, D), dtype=dtype)
            what = f"D = {D} {dtype}"
            t0 = time.time()
            qscann = model(qm9, "homo")
            _, inputs = qscann.featurize_structures(molecule)
            inputs = [{k: np.asarray(v) for k, v in inputs[0].items()}]
            reset()
            answers = qscann.predict_featurized(molecule, inputs)
            torch.cuda.synchronize()
            route = qscann.trainer.eval_route(inputs[0]["atomic"].shape[1],
                                              inputs[0]["neighbors"].shape[2])
            launched["scann_forward_d512"] += c1.d512_launches
            print(f"phase 22 served a QM9 molecule to a {what} model: route {route}, #1 "
                  f"launches {c1.launches} ({c1.d512_launches} d512, {c1.bf16_launches} bf16); "
                  f"{time.time() - t0:.1f} s  [{card}]", flush=True)
            if (route != "fused" or (c1.launches, c1.d512_launches) != (1, 1)
                    or c1.bf16_launches != (dtype == "bfloat16")):
                failures.append(f"phase 22 QM9 molecule {what}: route {route}, #1 launches "
                                f"{c1.launches} ({c1.d512_launches} d512)")
            held(f"QM9 molecule {what}", qscann, molecule, inputs, answers, [route])
            del qscann
            t0 = time.time()
            mscann = model(mp, "formation_energy_per_atom")
            reset()
            answers = mscann.predict_featurized(crystals, crystal_inputs, batch_size=4)
            torch.cuda.synchronize()
            routes = [mscann.trainer.eval_route(x["atomic"].shape[1], x["neighbors"].shape[2])
                      for x in crystal_inputs]
            launched["scann_loop_tall_d512"] += c3.tall_launches
            launched["scann_loop_wide_d512"] += c3.wide_launches
            print(f"phase 22 served MP2018 crystals of 300 and 40 sites at 16 and 80 "
                  f"neighbours to a {what} model: routes {routes}, #3 launches {c3.launches} "
                  f"({c3.d512_launches} d512: {c3.tall_launches} tall, {c3.wide_launches} wide; "
                  f"{c3.bf16_launches} bf16), #1 {c1.launches}, #5 {c5.launches}; "
                  f"{time.time() - t0:.1f} s  [{card}]", flush=True)
            if (routes != ["loop"] * 2 or c1.launches or c5.launches
                    or (c3.launches, c3.d512_launches, c3.tall_launches, c3.wide_launches)
                    != (2, 2, 1, 1) or c3.bf16_launches != 2 * (dtype == "bfloat16")):
                failures.append(f"phase 22 crystals {what}: routes {routes}, #3 launches "
                                f"{c3.launches} ({c3.d512_launches} d512, {c3.tall_launches} "
                                f"tall, {c3.wide_launches} wide)")
            held(f"MP2018 crystal {what}", mscann, crystals, crystal_inputs, answers, routes)
            del mscann
    # the per-layer route: #5's narrow and wide *_d512 builds, L launches each
    mp = widened(mp2018, 512, 512, 512)
    t0 = time.time()
    layered = model(dataclasses.replace(mp, use_attn_norm=False), "formation_energy_per_atom")
    structs = crystals[1:] * 2
    inputs = [record(40, 12), record(40, 80)]
    reset()
    answers = layered.predict_featurized(structs, inputs, batch_size=4)
    torch.cuda.synchronize()
    L = mp.n_attention
    launched["local_attention_wide_d512"] += c5.wide_launches
    launched["local_attention_d512"] += c5.d512_launches - c5.wide_launches
    routes = [layered.trainer.eval_route(x["atomic"].shape[1], x["neighbors"].shape[2])
              for x in inputs]
    print(f"phase 22 served two crystals of 40 sites to a D = 512 model without the attention "
          f"LayerNorm: routes {routes}, #5 launches {c5.launches} ({c5.d512_launches} d512, "
          f"{c5.wide_launches} wide), #3 {c3.launches}; {time.time() - t0:.1f} s  [{card}]",
          flush=True)
    if (routes != ["per_layer", "per_layer"] or c3.launches
            or (c5.launches, c5.d512_launches, c5.wide_launches) != (2 * L, 2 * L, L)):
        failures.append(f"phase 22 per-layer: routes {routes}, #5 launches {c5.launches} "
                        f"({c5.d512_launches} d512, {c5.wide_launches} wide); want {2 * L}, "
                        f"{2 * L}, {L}")
    held("per-layer crystal", layered, structs, inputs, answers, routes)
    del layered
    # Trainer.fit of a D = 384 QM9 model, one epoch: #4 (tall d512) steps, #1 validation
    qm9 = widened(qm9_model, 384, 384, 384)
    t0 = time.time()
    work = tempfile.mkdtemp(prefix="scann_chip_smoke_d512_")

    def bucket(n):
        x = {k: v.cpu().numpy() for k, v in synthetic_batch(rng, n, 32, 16).items()}
        return PackedBucket(x, rng.normal(size=n).astype(np.float32), np.arange(n))

    cfg = ScannConfig(model=qm9, hyper=HyperConfig(batch_size=16, lr=5e-4, epochs=1, seed=0,
                                                   save_path=os.path.join(work, "qm9")),
                      tpu=TpuConfig(max_buckets=2))
    trainer = Trainer(cfg, device="cuda", workdir=os.path.join(work, "qm9", "fit"))
    trainer.init_state(0)
    train, valid = [bucket(32)], [bucket(16)]
    routes = (trainer.train_route(32, 16), trainer.eval_route(32, 16))
    reset()
    kbwd.reset_counts(kbwd.launch_scann_backward)
    kbwd.reset_counts(kloop.launch_loop_backward)
    hist = trainer.fit(train, valid, epochs=1, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    launched["scann_forward_d512"] += c1.d512_launches
    c4 = kloop.launch_loop_backward
    n2, n4 = kbwd.launch_scann_backward.launches, c4.launches
    launched["scann_loop_backward_tall_d512"] += c4.d512_launches
    steps = -(-train[0].num_structures // 16)
    print(f"phase 22 fitted a D = 384 QM9 model for one epoch in a (32, 16) bucket: routes "
          f"(train, eval) {routes}, #1 launches {c1.launches} ({c1.d512_launches} d512), #2 "
          f"{n2}, #4 {n4} ({c4.d512_launches} d512, {c4.tall_launches} tall) for {steps} "
          f"steps, #5 {c5.launches}; loss {hist['loss']}, val MAE {hist['val_mae']}; "
          f"{time.time() - t0:.1f} s  [{card}]", flush=True)
    if (routes != ("loop", "fused") or c1.launches < 1 or c1.d512_launches != c1.launches
            or n2 or n4 != steps or c4.d512_launches != n4 or c4.tall_launches != n4
            or c5.launches or not np.isfinite(hist["loss"] + hist["val_mae"]).all()):
        failures.append(f"phase 22 fit: routes {routes}, #1 {c1.launches} ({c1.d512_launches} "
                        f"d512), #2 {n2}, #4 {n4} ({c4.d512_launches} d512) for {steps} steps, "
                        f"#5 {c5.launches}, history {hist}")
    kbwd.reset_counts(c4)
    reset()
    return launched


def phase22(qm9_model, mp2018, failures, card):
    """Phase 22: widths past 256. Returns the kernels line's rows of the nine
    *_d512 builds (#1, the tall and wide #3, the narrow and wide #5, and the
    tall and wide #4 in f32 and bf16)."""
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop

    t0 = time.time()
    worst, worst16 = phase22_holds(qm9_model, mp2018, failures)
    t1 = time.time()
    held4, held4_16 = phase22_backward_holds(qm9_model, mp2018, failures)
    t2 = time.time()
    times = phase22_times(qm9_model, mp2018, card)
    t3 = time.time()
    times.update(phase22_backward_times(qm9_model, mp2018, card))
    t4 = time.time()
    launched = phase22_paths(qm9_model, mp2018, failures, card)
    for name, n in phase22_train(mp2018, failures, card).items():
        launched[name] = launched.get(name, 0) + n
    print(f"phase 22 wall (s): holds {t1 - t0:.1f}, #4 holds {t2 - t1:.1f}, times "
          f"{t3 - t2:.1f}, #4 times {t4 - t3:.1f}, main paths {time.time() - t4:.1f}, in all "
          f"{time.time() - t0:.1f}  [{card}]", flush=True)
    replaces = {"scann_forward_d512": kfwd.REPLACES, "local_attention_d512": kla.REPLACES,
                "local_attention_wide_d512": kla.REPLACES}
    rows = []
    for name in D512_BUILDS:
        rows.append({"name": name, "route": "cuda", "source": f"scann_tpu_torch/csrc/{name}.cu",
                     "replaces": replaces.get(name, kloop.REPLACES), "launches": launched[name],
                     "max_abs_err": worst[name], "bf16_max_abs_err": worst16[name],
                     "library_ms": None, **times[name]})
        if not launched[name]:
            failures.append(f"phase 22: {name} was not launched on the main paths")
    # #4's d512 builds: the f32 rows held by phase22_backward_holds against
    # the f32 plain version, the bf16 ones by hold_bf16_shape (the recompute
    # schedule and the bf16 stash against their bf16 plain versions)
    for name in D512_BACKWARD_BUILDS:
        err = held4_16[name] if name.endswith("_bf16") else held4[name]
        rows.append({"name": name, "route": "cuda", "source": f"scann_tpu_torch/csrc/{name}.cu",
                     "replaces": kloop.BACKWARD_REPLACES, "launches": launched[name],
                     "max_abs_err": err, "library_ms": None, **times[name]})
        if not launched[name]:
            failures.append(f"phase 22: {name} was not launched on the main paths")
    return rows



def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from scann_tpu_torch.config import HyperConfig, ModelConfig, ScannConfig, TpuConfig
    from scann_tpu_torch.kernels import _build
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.models.scann import init_params, scann_forward
    from scann_tpu_torch.utils import exec_cache

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    t_start = t0 = time.time()
    # a fresh kernel build cache: the forced build fills it, and phase 13's
    # ranks and its served request must load from it without building
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "scann_tpu_torch", "chip_smoke_exec_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    cache = _build.set_build_dir(cache_dir)
    every = _build.SOURCES + _build.SHAPE_SOURCES + _build.PROBES
    _build.build_all(every, force=True)
    print(f"built {list(every)} with nvcc in "
          f"{time.time() - t0:.1f} s "
          f"(one nvcc per source, in parallel) into the build cache "
          f"{os.path.relpath(cache_dir)} ({cache.stats['compiles']} builds; "
          f"{exec_cache.env_fingerprint()})", flush=True)
    secs = _build.build_seconds
    for what, names in (("nine *_d512", [n for n in _build.WIDTH_SOURCES if "_d512" in n]),
                        ("four #4 *_d512", D512_BACKWARD_BUILDS)):
        print(f"the {what} sources' share of the build: "
              f"{sum(secs[n] for n in names):.1f} of {sum(secs.values()):.1f} nvcc-seconds "
              f"({100 * sum(secs[n] for n in names) / sum(secs.values()):.1f}%); each "
              f"{ {n: round(secs[n], 1) for n in names} }; the longest nvcc of all "
              f"{max(secs.values()):.1f} s", flush=True)
    for name in ("scann_backward", "scann_loop_backward", "scann_backward_bf16",
                 "scann_loop_backward_bf16", "scann_loop", "local_attention",
                 *_build.SHAPE_SOURCES):
        for entry, regs, stores, loads in _build.kernel_resources(name):
            if "reduce_rows" not in entry and "selftest" not in entry:
                print(f"{name}.cu: {regs} registers a thread, {stores} bytes of spill stores, "
                      f"{loads} bytes of spill loads (ptxas -v; {entry[-24:]})", flush=True)

    failures = []
    max_err = 0.0
    qm9_model = qm9_config()

    # the wall time of each phase (the script's budget)
    walls, mark = {}, [t_start]

    def lap(name):
        now = time.time()
        walls[name] = round(now - mark[0], 1)
        mark[0] = now

    lap("build")
    # ---- phases 11 and 12 (run first): the card's rates, the featurizers ----
    phase_rates(qm9_model, failures, card)
    phase_featurizers(failures, card)
    lap("11-12")

    # ---- phase 1: kernel vs plain version on the card ---------------------
    def compare(name, cfm, inputs, mrelu=False, seed=0):
        nonlocal max_err
        params = init_params(cfm, torch.Generator().manual_seed(seed), "cuda")
        with torch.inference_mode():
            pred, ga = kfwd.fused_scann_forward(params, inputs, cfm, mrelu)
            torch.cuda.synchronize()
            pred0, ga0 = kfwd.reference_scann_forward(params, inputs, cfm, mrelu)
        line = [name, f"B={inputs['atomic'].shape[0]} M={inputs['atomic'].shape[1]} "
                      f"N={inputs['neighbors'].shape[2]}{packed_label(inputs)}"]
        for what, got, want in (("pred", pred, pred0), ("ga", ga, ga0)):
            ab, rel, ok = errors(got, want)
            max_err = max(max_err, ab)
            line.append(f"{what} max_abs {ab:.3e} max_rel {rel:.3e}")
            if not ok:
                failures.append(f"{name} {what}: max_abs {ab:.3e} outside rtol {RTOL} atol {ATOL}")
        print("  ".join(line) + f"  (rtol {RTOL}, atol {ATOL})", flush=True)

    rng = np.random.default_rng(0)
    small = dict(n_atoms=10, embedding_dim=16, n_attention=2, local_dim=32, num_head=4,
                 global_dim=32, dense_out=16)
    matrix = [
        ("scann+", ModelConfig(**small, g_update=True), False),
        ("scann", ModelConfig(**small, g_update=False), False),
        ("scann ring mrelu", ModelConfig(**small, g_update=False, use_ring=True), True),
        ("scann+ ring", ModelConfig(**small, g_update=True, use_ring=True), False),
        ("scann+ cgcnn", ModelConfig(**small, g_update=True, feature="cgcnn"), False),
        ("scann+ ga_norm off", ModelConfig(**small, g_update=True, use_ga_norm=False), False),
    ]
    for name, cfm, mrelu in matrix:
        compare(name, cfm, synthetic_batch(rng, 8, 16, 8, cfm.use_ring,
                                           cfm.feature == "cgcnn"), mrelu)
    qm9_inputs = synthetic_batch(rng, 128, 32, 16)
    compare("qm9 full width", qm9_model, qm9_inputs)
    compare("qm9 single atoms", qm9_model, synthetic_batch(rng, 16, 8, 8, min_atoms=1))
    lone = synthetic_batch(rng, 4, 8, 8)
    lone["atom_mask"][0] = 0.0
    lone["atom_mask"][0, 0] = 1.0
    lone["neighbor_mask"][0] = 0.0
    compare("qm9 one-atom molecule", qm9_model, lone)
    compare("qm9 widest rung M=64", qm9_model, synthetic_batch(rng, 32, 64, 16))
    # packed slots (structure packing): the small matrix in slots of 16 rows, and
    # molecules of 3-29 atoms at the flagship's packing capacity 48 and the derived 32,
    # up to 8 segments a slot
    for name, cfm, mrelu in matrix:
        compare(f"{name} packed", cfm,
                pack_batch(synthetic_batch(rng, 12, 8, 8, cfm.use_ring, cfm.feature == "cgcnn"),
                           16), mrelu)
    qm9_mols = synthetic_batch(rng, 256, 29, 16)
    packed_qm9 = {cap: pack_batch(qm9_mols, cap) for cap in (48, 32)}
    for cap, xp in packed_qm9.items():
        compare(f"qm9 full width capacity {cap}", qm9_model, xp)

    lap("1")
    # ---- phase 2: the serving path, through HTTP --------------------------
    from scann_tpu_torch.api import Scann
    from scann_tpu_torch.data.structure import Structure
    from scann_tpu_torch.serve import BatchedPredictor, PredictionServer

    cfg = ScannConfig(model=qm9_model,
                      hyper=HyperConfig(batch_size=128, target="homo",
                                        target_mean=-0.24, target_std=0.022),
                      tpu=TpuConfig(max_buckets=2))
    scann = Scann(cfg, device="cuda")
    scann.init_params(seed=0)
    batches = [0]
    forward_eval = scann.forward_eval

    def counted_forward_eval(params, batch):
        batches[0] += 1
        return forward_eval(params, batch)

    scann.forward_eval = counted_forward_eval
    mols = MOLECULES
    kfwd.fused_scann_forward.launches = 0          # counts of the main path only
    t_serve = time.time()
    predictor = BatchedPredictor(scann, max_batch=64, window_ms=20.0,
                                 warmup_shapes=[(12, 16)])
    spans = ServingSpans(scann)
    server = PredictionServer(predictor, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://{server.host}:{server.port}"
    answers, latencies, sent, wall = {}, {}, {}, {}

    def post(name, body, ctype):
        t = time.perf_counter()
        req = urllib.request.Request(base + "/predict", data=body,
                                     headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                answers[name] = (r.status, json.loads(r.read()))
        except Exception as e:  # recorded, then reported as a failure below
            answers[name] = (getattr(e, "code", None), {"error": repr(e)})
        wall[name] = (len(mols[name][0]), t, time.perf_counter())
        latencies[name] = 1e3 * (wall[name][2] - t)

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = (r.status, json.loads(r.read()))
        calls = []
        for name in ("water", "methane", "ethanol"):
            sp, xyz = mols[name]
            body = json.dumps({"structures": [{"species": sp, "coords": xyz,
                                               "lattice": None}]}).encode()
            calls.append((name, body, "application/json"))
        sp, xyz = mols["benzene"]
        sent["benzene"] = f"{len(sp)}\nbenzene\n" + "".join(
            f"{s} {x:.4f} {y:.4f} {z:.4f}\n" for s, (x, y, z) in zip(sp, xyz))
        calls.append(("benzene", sent["benzene"].encode(), "text/plain"))
        threads = [threading.Thread(target=post, args=c) for c in calls]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
    finally:
        server.shutdown()
        thread.join(10)
    torch.cuda.synchronize()
    serve_s = time.time() - t_serve
    launches = kfwd.fused_scann_forward.launches
    device_batches = batches[0]
    spans.close()
    spans.report("phase 2", wall, card)

    print(f"healthz {health}", flush=True)
    if health[0] != 200 or health[1].get("status") != "ok":
        failures.append(f"healthz answered {health}")
    for name, (sp, xyz) in mols.items():
        status, out = answers.get(name, (None, {}))
        if status != 200:
            failures.append(f"{name}: HTTP {status} {out}")
            continue
        value, ga = out["predictions"][0], np.asarray(out["ga_scores"][0])
        # the reference featurizes exactly what was sent (the xyz text is rounded)
        struct = (Structure.from_xyz_lines(sent[name].splitlines()) if name in sent
                  else Structure(sp, xyz))
        _, inputs = scann.featurize_structures([struct])
        with torch.inference_mode():
            p0, g0 = scann_forward(scann.params, scann._to_device(inputs[0]), qm9_model)
        ref = p0[0, 0].item() * cfg.hyper.target_std + cfg.hyper.target_mean
        ref_ga = g0[0, :len(sp), 0].cpu().numpy()
        err_v = abs(value - ref)
        err_g = float(np.abs(ga - ref_ga).max())
        ok = (np.isfinite(value) and np.isfinite(ga).all() and ga.shape == (len(sp),)
              and err_v <= ATOL + RTOL * abs(ref)
              and np.all(np.abs(ga - ref_ga) <= ATOL + RTOL * np.abs(ref_ga)))
        print(f"{name}: HTTP 200 {cfg.hyper.target}={value:.6f} eager={ref:.6f} "
              f"|d|={err_v:.2e} ga max|d|={err_g:.2e} latency {latencies[name]:.1f} ms",
              flush=True)
        if not ok:
            failures.append(f"{name}: served answer differs from the eager model "
                            f"({err_v:.3e}, {err_g:.3e})")
    print(f"serving: {len(answers)} requests, {device_batches} device batches, "
          f"{launches} kernel launches, {serve_s:.1f} s from predictor start", flush=True)
    if launches == 0 or launches != device_batches:
        failures.append(f"kernel launches {launches} != device batches {device_batches}")

    lap("2")
    # ---- phase 3: time the kernel at the QM9 serving shape -----------------
    params = init_params(qm9_model, torch.Generator().manual_seed(0), "cuda")
    packed = kfwd.pack_params(params, qm9_model)
    with torch.inference_mode():
        kfwd._check_inputs(qm9_inputs, qm9_model, packed["wde"].device)
        kernel_ms = cuda_ms(lambda: kfwd._launch(packed, qm9_inputs, qm9_model, False))
        plain_ms = cuda_ms(lambda: kfwd.reference_scann_forward(params, qm9_inputs,
                                                                 qm9_model))
    B, M = qm9_inputs["atomic"].shape
    N = qm9_inputs["neighbors"].shape[2]
    flops = kfwd.forward_flops(qm9_model, B, M, N)
    nbytes = (sum(t.numel() * t.element_size() for t in qm9_inputs.values())
              + sum(t.numel() * t.element_size() for t in packed.values())
              + 4 * (B + B * M))
    fwd_bound, fwd_by, fwd_measured = bound_ms(flops, nbytes,
                                               kfwd.forward_fp32_flops(qm9_model, B, M, N))
    print(f"scann_forward at B={B} M={M} N={N}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, {flops:.4e} FLOP, {nbytes} bytes, bound "
          f"{fwd_bound:.4f} ms by {fwd_by} ({100 * fwd_bound / kernel_ms:.1f}% of it reached)  "
          f"[{card}]", flush=True)
    bwd_time = time_backward(qm9_model, params, packed, qm9_inputs, card)
    # the segmented kernels at the packed shapes: #1 at capacity 48, #2 at 32
    xp = packed_qm9[48]
    with torch.inference_mode():
        kfwd._check_inputs(xp, qm9_model, packed["wde"].device)
        p_ms, p_plain_ms = in_turns_ms(lambda: kfwd.reference_scann_forward(params, xp, qm9_model),
                                       lambda: kfwd._launch(packed, xp, qm9_model, False), 2, 5)
    B, M = xp["atomic"].shape
    N = xp["neighbors"].shape[2]
    p_flops = kfwd.forward_flops(qm9_model, B, M, N)
    p_bound, p_by, p_measured = bound_ms(p_flops, tensor_bytes(xp.values(), packed.values())
                                         + 4 * (B * xp["segment_onehot"].shape[-1] + B * M),
                                         kfwd.forward_fp32_flops(qm9_model, B, M, N))
    print(f"scann_forward at B={B} M={M} N={N}{packed_label(xp)} (timed in turns: plain, "
          f"kernel, kernel, plain): kernel {p_ms:.4f} ms, plain {p_plain_ms:.4f} ms, "
          f"{p_flops:.4e} FLOP, bound {p_bound:.4f} ms by {p_by} "
          f"({100 * p_bound / p_ms:.1f}% of it reached)  [{card}]", flush=True)
    fwd_packed_time = {"ms": p_ms, "plain_ms": p_plain_ms, "bound_ms": p_bound,
                       "bound_by": p_by, "measured_bound_ms": p_measured, "flops": p_flops}
    bwd_packed_time = time_backward(qm9_model, params, packed, packed_qm9[32], card)

    lap("3")
    # ---- phase 4: the backward kernel against its plain version -------------
    check_products(failures, card)
    bwd_err = phase4(matrix, qm9_model, qm9_inputs, packed_qm9, failures, card)

    lap("4")
    # ---- phase 5: the training path, then with structure packing --------------
    _, qm9_run = phase5(qm9_model, failures, card)
    lap("5")
    packed_launches = train_packed("phase 5 packed capacity 48", qm9_model, qm9_run, 48, 3, 128,
                                   ("fused", "loop"), failures, card, compare_unpacked=True)
    derived = train_packed("phase 5 packed derived capacity", qm9_model, qm9_run, None, 1, 128,
                           ("fused", "fused"), failures, card)
    packed_launches = {k: v + derived[k] for k, v in packed_launches.items()}

    lap("5 packed")
    # ---- phases 6-8: crystals ---------------------------------------------------
    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_loop as kloop

    mp2018, ptgp = crystal_models()
    mp_packed = pack_batch(synthetic_batch(np.random.default_rng(66), 64, 90, 32,
                                           n_atoms=mp2018.n_atoms, min_atoms=20), 96)
    loop_err, loop_time = phase6(matrix, mp2018, ptgp, mp_packed, failures, card)
    lap("6")
    layer_err, layer_time = phase7(mp2018, failures, card)
    lap("7")

    # ---- phases 9-10: crystal training, then phase 8 serves what phase 10 trained --
    loop_bwd_err, loop_bwd_time = phase9(matrix, mp2018, ptgp, qm9_model,
                                         {"qm9": packed_qm9[48], "mp2018": mp_packed}, failures,
                                         card)
    lap("9")
    _, run_dir, crystal_run = phase10(mp2018, failures, card)
    lap("10")
    crystal_packed = train_packed("phase 10 packed capacity 96", mp2018, crystal_run, 96, 1, 64,
                                  ("loop", "loop"), failures, card, neighbors_multiple=32,
                                  compare_unpacked=True)
    packed_launches = {k: v + crystal_packed[k] for k, v in packed_launches.items()}
    lap("10 packed")
    loop_launches, layer_launches = phase8(mp2018, run_dir, failures, card)
    lap("8")

    # ---- phase 14: model.dtype bfloat16 ------------------------------------------
    bf16_rows, shape16 = phase14(matrix, qm9_model, mp2018, qm9_inputs, packed_qm9, mp_packed,
                                 failures, card)

    lap("14")
    # ---- phase 15: model.dtype bfloat16 training ------------------------------------
    torch.cuda.empty_cache()
    wide16, rows15 = phase15(matrix, qm9_model, mp2018, qm9_inputs, packed_qm9, qm9_run,
                             crystal_run, failures, card)
    bf16_rows += rows15
    shape16.update(wide16)

    lap("15")
    # ---- phase 16: the activation stashes of #2 and #4 ----------------------------------
    torch.cuda.empty_cache()
    stash_rows, recompute_err = phase16(
        qm9_model, mp2018, ptgp, qm9_inputs, packed_qm9, mp_packed,
        {2: qm9_run["schedules"], 4: crystal_run["schedules"]},
        {2: bwd_err["backward"], 4: loop_bwd_err}, failures, card)

    lap("16")
    # ---- phase 17: wide neighbour lists in #5, #3 and #4 -------------------------------
    torch.cuda.empty_cache()
    wide_rows, layer16 = phase17(mp2018, ptgp, failures, card)
    lap("17")
    # ---- phase 18: tall structures in #3 and #4 ----------------------------------------
    torch.cuda.empty_cache()
    tall_data, tall_rows = phase18(mp2018, ptgp, failures, card)
    lap("18")
    # ---- phase 19: the bf16 operand mode in the wide and tall builds of #3 and #4 ------
    torch.cuda.empty_cache()
    shape16_rows = phase19(mp2018, ptgp, tall_data, shape16, layer16, failures, card)
    lap("19")
    # ---- phase 20: widths above 128 in #1, #3, #4 and #5 (the *_d256 builds) -----------
    torch.cuda.empty_cache()
    width_rows = phase20(qm9_model, mp2018, failures, card)
    lap("20")
    # ---- phase 21: the user's scripts (examples_torch/) on the card ----------------------
    torch.cuda.empty_cache()
    scripts_launches = phase21(qm9_model, qm9_run, failures, card)
    lap("21")
    # ---- phase 22: widths past 256 in #1, #3, #4 and #5 (the *_d512 builds) ---------
    torch.cuda.empty_cache()
    width512_rows = phase22(qm9_model, mp2018, failures, card)
    lap("22")
    # ---- phase 13: two ranks of the data-parallel Trainer from the build cache --
    torch.cuda.empty_cache()
    sharded_launches = phase13(qm9_model, mp2018, qm9_run, cache_dir, failures, card)
    lap("13")
    print(f"wall time by phase (s): {walls}", flush=True)

    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), flush=True)
        return 1
    from scann_tpu_torch.kernels import scann_backward as kbwd

    # "packed_launches": the packed training paths' launches (phase 5 packed at
    # capacities 48 and 32, phase 10 packed at 96); "packed": the segmented
    # kernel timed at a packed shape. The rows scann_backward and
    # scann_loop_backward are the recompute schedule, timed by phases 3 and 9;
    # their launches are the recompute launches, and the stash rows of phase 16
    # take the launches of their own schedule
    for row in stash_rows:
        for key, counts in (("packed_launches", packed_launches),
                            ("sharded_launches", sharded_launches),
                            ("scripts_launches", scripts_launches)):
            row[key] = counts[f"{row['kernel']}/{row['schedule']}"]
    kernels = [{
        "name": "scann_forward", "route": "cuda", "source": kfwd.SOURCE,
        "replaces": kfwd.REPLACES, "launches": launches,
        "max_abs_err": max(max_err, bwd_err["forward_dropout"]), "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
        "measured_bound_ms": fwd_measured, "library_ms": None, "flops": flops,
        "packed_launches": packed_launches["scann_forward"], "packed": fwd_packed_time,
        "sharded_launches": sharded_launches["scann_forward"],
        "scripts_launches": scripts_launches["scann_forward"],
    }, {
        "name": "scann_backward", "schedule": "recompute", "route": "cuda",
        "source": kbwd.SOURCE, "replaces": kbwd.REPLACES,
        "launches": qm9_run["schedules"]["recompute"],
        "max_abs_err": recompute_err[2], "ms": bwd_time["ms"],
        "plain_ms": bwd_time["plain_ms"], "bound_ms": bwd_time["bound_ms"],
        "bound_by": bwd_time["bound_by"], "measured_bound_ms": bwd_time["measured_bound_ms"],
        "library_ms": None, "flops": bwd_time["flops"],
        "recompute_flops": bwd_time["recompute_flops"],
        "packed_launches": packed_launches["scann_backward/recompute"],
        "packed": {k: bwd_packed_time[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "measured_bound_ms", "flops")},
        "sharded_launches": sharded_launches["scann_backward/recompute"],
        "scripts_launches": scripts_launches["scann_backward/recompute"],
    }, {
        "name": "scann_loop", "route": "cuda", "source": kloop.SOURCE,
        "replaces": kloop.REPLACES, "launches": loop_launches, "max_abs_err": loop_err,
        "library_ms": None, "packed_launches": packed_launches["scann_loop"], **loop_time,
        "sharded_launches": sharded_launches["scann_loop"],
        "scripts_launches": scripts_launches["scann_loop"],
    }, {
        "name": "scann_loop_backward", "schedule": "recompute", "route": "cuda",
        "source": kloop.BACKWARD_SOURCE, "replaces": kloop.BACKWARD_REPLACES,
        "launches": crystal_run["schedules"]["recompute"],
        "max_abs_err": recompute_err[4], "library_ms": None,
        "packed_launches": packed_launches["scann_loop_backward/recompute"], **loop_bwd_time,
        "sharded_launches": sharded_launches["scann_loop_backward/recompute"],
        "scripts_launches": scripts_launches["scann_loop_backward/recompute"],
    }, {
        # phase 8's per-layer launches (none since the tall #3 serves every
        # f32 crystal rung at N <= 64) and phase 14's f32 request to a model
        # with use_attn_norm: false
        "name": "local_attention", "route": "cuda", "source": kla.SOURCE,
        "replaces": kla.REPLACES,
        "launches": layer_launches + bf16_rows[2]["f32_entry_launches"],
        "max_abs_err": layer_err,
        "library_ms": None, **layer_time,
        "sharded_launches": sharded_launches["local_attention"],
        "scripts_launches": scripts_launches["local_attention"],
    }, *bf16_rows, *stash_rows, *wide_rows, *tall_rows, *shape16_rows, *width_rows,
        *width512_rows]
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms, {100 * k['bound_ms'] / k['ms']:.1f}% of its bound "
              f"at the published rates ({k['bound_ms']:.4f} ms), "
              f"{100 * k['measured_bound_ms'] / k['ms']:.1f}% of it at the measured rates "
              f"({k['measured_bound_ms']:.4f} ms)  [{card}]", flush=True)
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all, the build included  [{card}]",
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def d256_ab_times(kloop, kbwd, kfwd, init_params, qm9_model, mp2018):
    """``--backward-ab``'s times of #4's d256 builds (one-shot, dropout 0.1, 5
    timed launches after 2), with the checkout's modules: label -> {ms, C,
    bound_ms, bound_by}."""
    import dataclasses

    bf16 = lambda cfm: dataclasses.replace(cfm, dtype="bfloat16")
    qm9, mp = widened(qm9_model, 256, 256, 256), widened(mp2018, 256, 256, 256)
    mp136 = widened(mp2018, 136, 132, 140)
    own = getattr(kloop, "backward_cluster", None)
    out = {}
    for label, cfm, B, M, N, mode, C in (
            ("tall MP2018 (64, 96, 32) f32 stash", mp, 64, 96, 32, "f32", None),
            ("tall MP2018 (64, 96, 32) recompute", mp, 64, 96, 32, None, None),
            ("tall QM9 (128, 32, 16) f32 stash", qm9, 128, 32, 16, "f32", None),
            ("tall QM9 (128, 32, 16) recompute", qm9, 128, 32, 16, None, None),
            ("wide MP2018 (16, 80, 96) f32 stash", mp, 16, 80, 96, "f32", None),
            ("wide MP2018 (16, 80, 96) recompute", mp, 16, 80, 96, None, None),
            ("wide MP2018 (16, 80, 96) f32 stash C=4", mp, 16, 80, 96, "f32", 4),
            ("wide MP2018 (16, 80, 96) recompute C=4", mp, 16, 80, 96, None, 4),
            ("wide MP2018 (64, 80, 96) recompute", mp, 64, 80, 96, None, None),
            ("wide D=136 MP2018 (16, 80, 96) f32 stash C=4", mp136, 16, 80, 96, "f32", 4),
            ("tall bf16 MP2018 (64, 96, 32) f32 stash", bf16(mp), 64, 96, 32, "f32", None),
            ("wide bf16 MP2018 (16, 80, 96) f32 stash", bf16(mp), 16, 80, 96, "f32", None)):
        rng = np.random.default_rng(241)
        x = (synthetic_batch(rng, B, M, N, n_atoms=cfm.n_atoms, min_atoms=min(20, M))
             if N <= 32 else wide_batch(rng, B, M, N, cfm))
        f32 = dataclasses.replace(cfm, dtype="float32")
        packed = kfwd.pack_params(init_params(f32, torch.Generator().manual_seed(0), "cuda"), f32)
        y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        if C is None:
            C = own(cfm, B, M, N) if own else kloop.cluster_size(B)
        scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, C, mode)
        ms = statistics.median(cuda_times(
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch, C, stash=mode), 5, warmup=2))
        _, P = kbwd.grad_layout(packed)
        bound, by, _ = bound_ms(kloop.loop_backward_flops(cfm, B, M, N),
                                tensor_bytes(x.values(), weights(packed)) + 4 * B + 4 * (P + B),
                                kbwd.backward_fp32_flops(cfm, B, M, N),
                                bf16=cfm.dtype == "bfloat16")
        out[label] = {"ms": ms, "C": C, "bound_ms": bound, "bound_by": by}
        del scratch, x
    return out


def d256_forward_ab(kloop, kla, kfwd, init_params, mp2018, saved=None):
    """``--backward-ab``'s times of the forward builds past 128 columns, with
    the checkout's modules: #1 at QM9 (B, 32, 16), B = 1, 16 and 128; the
    tall #3 at MP2018 (B, 96, 32) and the wide #3 at MP2018 (B, 80, 96), B =
    1, 16 and 64, at the checkout's own cluster size; all f32 and bf16; the
    narrow #5 at one MP2018 layer (64, 96, 32) and at (8, 256, 32), and the
    wide #5 at (1, 48, 96), (8, 96, 96) and (64, 96, 96), f32 and bf16
    tensors (10 timed launches after 3): label -> {ms, bound_ms, bound_by}
    (#5: {ms, plan}). With ``saved`` (a dict), one launch's outputs of each,
    #1 at QM9 (4, 32, 16), at (8, 8, 8) of 1-8 atoms, on a packed batch
    (capacity 48) and with dropout on (0.1, seed 7, ``mol_base`` 40), the
    tall #3 at MP2018 (4, 96, 32), the wide one at (4, 80, 97) (a last
    sub-chunk of one row), both at C = 2, the narrow #5 at (4, 48, 32) and
    the wide one at (2, 40, 97), for ``--ab-compare``."""
    import dataclasses

    mp = widened(mp2018, 256, 256, 256)
    bf16 = dataclasses.replace(mp, dtype="bfloat16")
    packed = kfwd.pack_params(init_params(mp, torch.Generator().manual_seed(0), "cuda"), mp)
    out = {}
    qm9 = widened(qm9_config(), 256, 256, 256)
    qm9_16 = dataclasses.replace(qm9, dtype="bfloat16")
    qp = kfwd.pack_params(init_params(qm9, torch.Generator().manual_seed(0), "cuda"), qm9)
    for B in (1, 16, 128):
        x = synthetic_batch(np.random.default_rng(270), B, 32, 16)
        flops = kfwd.forward_flops(qm9, B, 32, 16)
        nbytes = tensor_bytes(x.values(), weights(qp)) + 4 * (B + B * 32)
        for cfm in (qm9, qm9_16):
            # the checkout's own blocks a molecule (one before clusters)
            C = kfwd.forward_cluster(cfm, B, 32, 16) if hasattr(kfwd, "forward_cluster") else 1
            with torch.inference_mode():
                ms = statistics.median(cuda_times(lambda: kfwd._launch(qp, x, cfm, False), 10,
                                                  warmup=3))
            bound, by, _ = bound_ms(flops, nbytes, kfwd.forward_fp32_flops(cfm, B, 32, 16),
                                    bf16=cfm is qm9_16)
            out[f"1-d256 {cfm.dtype} QM9 ({B}, 32, 16)"] = {"ms": ms, "bound_ms": bound,
                                                            "bound_by": by, "cluster": C}
        del x
    for build, M, N in (("3-d256", 96, 32), ("3-wide-d256", 80, 96)):
        for B in (1, 16, 64):
            x = (synthetic_batch(np.random.default_rng(250), B, M, N, n_atoms=mp.n_atoms,
                                 min_atoms=20) if N <= 32
                 else wide_batch(np.random.default_rng(254), B, M, N, mp))
            flops = kloop.loop_forward_flops(mp, B, M, N)
            nbytes = (tensor_bytes(x.values(), weights(packed))
                      + 4 * (B + B * M) + kloop.loop_forward_bytes(mp, B, M, N))
            for cfm in (mp, bf16):
                C = kloop.forward_cluster(cfm, B, M, N)
                scratch = kloop.loop_forward_scratch(cfm, B, M, N, "cuda", C)
                with torch.inference_mode():
                    ms = statistics.median(cuda_times(
                        lambda: kloop._launch(packed, x, cfm, False, 0.0, 0, 0, C, scratch), 10,
                        warmup=3))
                bound, by, _ = bound_ms(flops, nbytes, kfwd.forward_fp32_flops(cfm, B, M, N),
                                        bf16=cfm is bf16)
                out[f"{build} {cfm.dtype} MP2018 ({B}, {M}, {N}) C={C}"] = {
                    "ms": ms, "bound_ms": bound, "bound_by": by}
                del scratch
            del x
    for build, B, M, N in (("5-d256", 64, 96, 32), ("5-d256", 8, 256, 32),
                           ("5-wide-d256", 1, 48, 96), ("5-wide-d256", 8, 96, 96),
                           ("5-wide-d256", 64, 96, 96)):
        args = layer_inputs(np.random.default_rng(251), B, M, N, 256, mp.num_head, True)
        for dt in (torch.float32, torch.bfloat16):
            typed = layer_cast(args, dt)
            with torch.inference_mode():
                ms = statistics.median(cuda_times(lambda: kla._launch(*typed), 10, warmup=3))
            out[f"{build} {str(dt)[6:]} ({B}, {M}, {N})"] = {
                "ms": ms, "plan": list(kla.make_plan(B, M, N, 256, mp.num_head, True,
                                                     kla.sm_count(args[0].device),
                                                     dt == torch.bfloat16))}
        del args, typed
    if saved is not None:
        unpacked = synthetic_batch(np.random.default_rng(271), 4, 32, 16)
        cases = (("(4, 32, 16)", unpacked, ()),
                 ("(8, 8, 8)", synthetic_batch(np.random.default_rng(272), 8, 8, 8, min_atoms=1),
                  ()),
                 ("packed 48", pack_batch(synthetic_batch(np.random.default_rng(273), 12, 29, 16),
                                          48), ()),
                 ("dropout 0.1", unpacked, (0.1, 7, 40)))
        for name, cfm in (("scann_forward_d256", qm9), ("scann_forward_d256_bf16", qm9_16)):
            saved[name] = {}
            with torch.inference_mode():
                for label, xs, drop in cases:
                    pred, ga = kfwd._launch(qp, xs, cfm, False, *drop)
                    saved[name][f"{label} pred"], saved[name][f"{label} ga"] = pred.cpu(), ga.cpu()
        x = synthetic_batch(np.random.default_rng(252), 4, 96, 32, n_atoms=mp.n_atoms,
                            min_atoms=20)
        wide_x = wide_batch(np.random.default_rng(255), 4, 80, 97, mp)
        for name, cfm, xs in (("scann_loop_tall_d256", mp, x),
                              ("scann_loop_tall_d256_bf16", bf16, x),
                              ("scann_loop_wide_d256", mp, wide_x),
                              ("scann_loop_wide_d256_bf16", bf16, wide_x)):
            B, M = xs["atomic"].shape[:2]
            N = xs["neighbors"].shape[2]
            scratch = kloop.loop_forward_scratch(cfm, B, M, N, "cuda", 2)
            with torch.inference_mode():
                saved[name] = [t.cpu() for t in kloop._launch(packed, xs, cfm, False, 0.0, 0, 0,
                                                              2, scratch)]
        for tag, (B, M, N) in (("", (4, 48, 32)), ("_wide", (2, 40, 97))):
            args = layer_inputs(np.random.default_rng(253), B, M, N, 256, mp.num_head, True)
            if N > 64:
                wide_masks(args[3])
            with torch.inference_mode():
                for name, dt in ((f"local_attention{tag}_d256", torch.float32),
                                 (f"local_attention{tag}_d256_bf16", torch.bfloat16)):
                    saved[name] = [None if t is None else t.cpu()
                                   for t in kla._launch(*layer_cast(args, dt))]
    return out


def backward_ab(root, out_path=None):
    """``--backward-ab ROOT [OUT]``: one turn of an A/B comparison of the
    narrow builds of #2, #3, #4 and #5 between two checkouts on one card.
    Imports ``scann_tpu_torch`` from the checkout ROOT (its kernels built
    there first) and times each kernel at its main shape: #2 at QM9 (128,
    32, 16) and #4 at MP2018 (64, 96, 32), one-shot launches at dropout 0.1
    through the public launchers in the schedule that checkout picks for
    this environment; #3 at MP2018 (64, 96, 32) and #5 at one MP2018 layer
    (64, 96, 32), SCANN+; each 3 warm-up and 10 timed launches (CUDA
    events). Prints the medians as one JSON line; with OUT, saves every
    kernel's outputs there (``torch.save``; gradients by name), and one
    launch's outputs of every other build both checkouts have: #1 at QM9,
    #2 and #4 in bf16 (QM9, MP2018 (64, 96, 32)), #3 in bf16 (MP2018), the
    wide builds of #3 and #4 at MP2018 (8, 80, 96) (#4 in bf16 too, and at
    (8, 64, 48)) and of #5 at one MP2018
    layer (8, 96, 96), the tall builds of #3 and #4 (f32 and bf16) at
    Pt/graphene (4, 322, 32), so that two checkouts' outputs can be held
    (``--ab-compare``). Also times #4's tall build (one-shot, dropout 0.1,
    5 timed launches after 2) at M = 322, N = 32: Pt/graphene and MP2018 at
    the recipe batch of 64 (C = 2, recompute), Pt/graphene at 16 (C = 4)
    with the f32 stash and recompute and in bf16 with the f32 stash; and
    #4's wide build the same way at MP2018 (64, 80, 96) recompute and (64,
    64, 48) f32 stash (C = 2), (16, 80, 96) f32 stash and recompute and bf16
    f32 stash (C = 4). Times #5's wide build, SCANN+, in f32 and on bf16
    tensors at (1, 48, 96), (8, 96, 96) and (64, 96, 96) (10 timed launches
    after 3; ``out["layer_wide"]``). Times #3's tall build at Pt/graphene (B, 322, 32)
    and its wide build at MP2018 (B, 80, 96), B = 1, 16 and 64, in f32 and
    in bf16 (10 timed launches after 3, at the checkout's own cluster size:
    ``forward_cluster`` where it has one, else ``cluster_size``), and saves
    their outputs at Pt/graphene (4, 322, 32) and MP2018 (8, 80, 96) in
    both modes (the bf16 ones with the f32-noise floor of their plain
    version). With OUT it also saves #1 in the bf16 operand mode at QM9,
    #5 on bfloat16 tensors at (64, 96, 32) and (8, 96, 96), and the ``ptxas
    -v`` lines of every build of the checkout (``_build.kernel_resources``,
    read from the logs beside its cached libraries: build them first).
    Times #4's builds past 128 columns (``d256_ab_times``: the tall one at
    MP2018 (64, 96, 32) and QM9 (128, 32, 16), the wide one at (16, 80, 96)
    in both f32 schedules, the recipe bucket (64, 80, 96) in the recompute
    schedule, the bf16 builds, at the checkout's own cluster size and the
    wide one at C = 4 too, ``out["d256"]``) and with OUT saves their
    gradients at a fixed C = 2 (``AB_WITHIN``). Times the forward builds
    past 128 columns (``d256_forward_ab``: #1 at QM9 (B, 32, 16), B = 1,
    16, 128, the tall #3 at MP2018 (B, 96, 32) and the wide #3 at (B, 80,
    96), B = 1, 16, 64, the narrow #5 at one MP2018 layer and (8, 256, 32)
    and the wide #5 at (1, 48, 96), (8, 96, 96) and (64, 96, 96), f32 and
    bf16, ``out["d256_forward"]``) and with OUT saves their outputs (#1
    unpacked, packed and with dropout; #3 at C = 2), held bit for bit. Run the turns
    A, B, B, A, each a process of its own."""
    sys.path.insert(0, os.path.abspath(root))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import dataclasses

    from scann_tpu_torch.kernels import local_attention as kla
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    where = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(kbwd.__file__))))
    if where != os.path.abspath(root):
        print(f"chip_smoke: scann_tpu_torch came from {where}, not {root}", file=sys.stderr)
        return 1
    rng = np.random.default_rng(17)
    out = {"root": root, "env": {k: v for k, v in os.environ.items() if "STASH" in k}}
    saved = {}
    mp2018, ptgp = crystal_models()
    mp_x = synthetic_batch(rng, 64, 96, 32, n_atoms=mp2018.n_atoms, min_atoms=20)
    qm9_x = synthetic_batch(rng, 128, 32, 16)
    bf16 = lambda cfm: dataclasses.replace(cfm, dtype="bfloat16")

    def launcher(name, cfm, x, packed, params=None):
        """One launch of ``name``'s kernel at ``x`` -> its outputs (the
        backward kernels' gradients by name; for ``AB_FLOOR`` also the
        f32-noise floor of the plain version at ``params``)."""
        B, M = x["atomic"].shape[:2]
        N = x["neighbors"].shape[2]
        y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        if name.startswith("scann_backward"):
            run = lambda: kbwd.launch_scann_backward(packed, x, cfm, y, None, True, False, 0.1, 7)
        elif name.startswith("scann_loop_backward"):
            scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N)
            run = lambda: kloop.launch_loop_backward(packed, x, cfm, y, None, True, False, 0.1,
                                                     7, 0, scratch)
        elif name.startswith("scann_loop"):
            scratch = kloop.loop_forward_scratch(cfm, B, M, N, "cuda")
            run = lambda: kloop._launch(packed, x, cfm, False, 0.0, 0, 0, None, scratch)
        else:
            run = lambda: kfwd._launch(packed, x, cfm, False)

        def outputs():
            got = run()
            if "backward" in name:
                flat, pred = got
                out = {"pred": pred.cpu(), **{k: v.cpu() for k, v in
                                              kbwd.grads_from_flat(flat, packed, cfm).items()}}
                if name in AB_FLOOR:
                    out["floor"] = torch.tensor(bf16_grad_floor(params, x, y, cfm))
                return out
            return [t.cpu() for t in got]
        return run, outputs

    for name, cfm, x in (("scann_backward", qm9_config(), qm9_x),
                         ("scann_loop_backward", mp2018, mp_x), ("scann_loop", mp2018, mp_x)):
        packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(17), "cuda"),
                                  cfm)
        run, outputs = launcher(name, cfm, x, packed)
        out[name] = statistics.median(cuda_times(run, 10, warmup=3))
        saved[name] = outputs()
    args = layer_inputs(np.random.default_rng(7), 64, 96, 32, mp2018.local_dim,
                        mp2018.num_head, True)
    with torch.inference_mode():
        out["local_attention"] = statistics.median(cuda_times(lambda: kla._launch(*args), 10,
                                                              warmup=3))
        saved["local_attention"] = [t.cpu() for t in kla._launch(*args)]
    # #5's wide build, SCANN+, in f32 and on bf16 tensors: the served crystal's
    # (1, 48, 96), one MP2018 layer at (8, 96, 96) and an eval batch of 64
    out["layer_wide"] = {}
    for B, M in ((1, 48), (8, 96), (64, 96)):
        args = layer_inputs(np.random.default_rng(8), B, M, 96, mp2018.local_dim,
                            mp2018.num_head, True)
        for dt in (torch.float32, torch.bfloat16):
            typed = layer_cast(args, dt)
            with torch.inference_mode():
                out["layer_wide"][f"{str(dt)[6:]} ({B}, {M}, 96)"] = statistics.median(
                    cuda_times(lambda: kla._launch(*typed), 10, warmup=3))
        del args, typed
    # #4's tall build at M = 322, N = 32: the recipe batch of 64 (2 blocks a
    # structure, the recompute schedule its f32 stash's size gives there) and
    # the batch of 16 (4 blocks) in both f32 schedules and in bf16
    out["tall"] = {}
    for label, cfm, B, mode, C in (
            ("Pt/graphene (64, 322, 32) recompute C=2", ptgp, 64, None, 2),
            ("MP2018 (64, 322, 32) recompute C=2", mp2018, 64, None, 2),
            ("Pt/graphene (16, 322, 32) f32 stash C=4", ptgp, 16, "f32", 4),
            ("Pt/graphene (16, 322, 32) recompute C=4", ptgp, 16, None, 4),
            ("Pt/graphene bf16 (16, 322, 32) f32 stash C=4", bf16(ptgp), 16, "f32", 4)):
        x = synthetic_batch(np.random.default_rng(181), B, 322, 32, use_ring=cfm.use_ring,
                            n_atoms=cfm.n_atoms, min_atoms=240)
        f32 = dataclasses.replace(cfm, dtype="float32")
        packed = kfwd.pack_params(init_params(f32, torch.Generator().manual_seed(0), "cuda"),
                                  f32)
        y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        scratch = kloop.loop_backward_scratch(packed, cfm, B, 322, 32, C, mode, tall=True)
        out["tall"][label] = statistics.median(cuda_times(
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch, C, stash=mode, tall=True), 5, warmup=2))
        del scratch, x
    # #4's wide build at the recipe batch of 64 (C = 2: recompute at (80, 96),
    # whose f32 stash exceeds the budget; the f32 stash at (64, 48)) and at 16
    # (C = 4) in both f32 schedules and in bf16 with the f32 stash
    out["wide"] = {}
    for label, cfm, B, M, N, mode, C in (
            ("MP2018 (64, 80, 96) recompute C=2", mp2018, 64, 80, 96, None, 2),
            ("MP2018 (64, 64, 48) f32 stash C=2", mp2018, 64, 64, 48, "f32", 2),
            ("MP2018 (16, 80, 96) f32 stash C=4", mp2018, 16, 80, 96, "f32", 4),
            ("MP2018 (16, 80, 96) recompute C=4", mp2018, 16, 80, 96, None, 4),
            ("MP2018 bf16 (16, 80, 96) f32 stash C=4", bf16(mp2018), 16, 80, 96, "f32", 4)):
        x = wide_batch(np.random.default_rng(191), B, M, N, cfm)
        packed = kfwd.pack_params(init_params(mp2018, torch.Generator().manual_seed(0), "cuda"),
                                  mp2018)
        y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, C, mode)
        out["wide"][label] = statistics.median(cuda_times(
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch, C, stash=mode), 5, warmup=2))
        del scratch, x
    # #4's builds past 128 columns at D = G = O = 256: the tall one at MP2018
    # (64, 96, 32) and QM9 (128, 32, 16), the wide one at (16, 80, 96) (also
    # at C = 4, the cluster size before the d256 rule) in the f32 stash and
    # recompute, the MP2018 recipe bucket (64, 80, 96) in the recompute
    # schedule its 13.7 GB stash leaves it, and the bf16 builds with the f32
    # stash, and the wide one at (136, 132, 140) and C = 4 (its sub-chunk the
    # plan's); each at the checkout's own cluster size unless named, beside
    # its bound (``loop_backward_flops``)
    out["d256"] = d256_ab_times(kloop, kbwd, kfwd, init_params, qm9_config(), mp2018)
    # #1, the tall and wide #3 and the narrow and wide #5 past 128 columns
    # (the 32-column products)
    out["d256_forward"] = d256_forward_ab(kloop, kla, kfwd, init_params, mp2018,
                                          saved if out_path else None)
    # #3's tall and wide builds at B = 1, 16 and the recipe batch of 64, in f32
    # and bf16, at the checkout's own cluster size
    out["forward"] = {}
    own = getattr(kloop, "forward_cluster", None)
    for build, cfm in (("tall Pt/graphene", ptgp), ("wide MP2018", mp2018)):
        packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cuda"),
                                  cfm)
        for B in (1, 16, 64):
            if build.startswith("tall"):
                x = synthetic_batch(np.random.default_rng(181), B, 322, 32, use_ring=True,
                                    n_atoms=cfm.n_atoms, min_atoms=240)
            else:
                x = wide_batch(np.random.default_rng(191), B, 80, 96, cfm)
            M, N = x["atomic"].shape[1], x["neighbors"].shape[2]
            for mode in (cfm, bf16(cfm)):
                C = own(mode, B, M, N) if own else kloop.cluster_size(B)
                scratch = kloop.loop_forward_scratch(mode, B, M, N, "cuda", C)
                with torch.inference_mode():
                    ms = statistics.median(cuda_times(
                        lambda: kloop._launch(packed, x, mode, False, 0.0, 0, 0, C, scratch), 10,
                        warmup=3))
                out["forward"][f"{build} {mode.dtype} ({B}, {M}, {N}) C={C}"] = ms
                del scratch
            del x
    if out_path:
        wide_x = wide_batch(rng, 8, 80, 96, mp2018)
        wide48_x = wide_batch(rng, 8, 64, 48, mp2018)
        tall_x = synthetic_batch(rng, 4, 322, 32, use_ring=True, n_atoms=ptgp.n_atoms,
                                 min_atoms=240)
        for name, cfm, x in (("scann_forward", qm9_config(), qm9_x),
                             ("scann_backward_bf16", bf16(qm9_config()), qm9_x),
                             ("scann_loop_bf16", bf16(mp2018), mp_x),
                             ("scann_loop_backward_bf16", bf16(mp2018), mp_x),
                             ("scann_loop_wide", mp2018, wide_x),
                             ("scann_loop_backward_wide", mp2018, wide_x),
                             ("scann_loop_backward_wide_bf16", bf16(mp2018), wide_x),
                             ("scann_loop_backward_wide_n48", mp2018, wide48_x),
                             ("scann_loop_tall", ptgp, tall_x),
                             ("scann_loop_backward_tall", ptgp, tall_x),
                             ("scann_loop_backward_tall_bf16", bf16(ptgp), tall_x)):
            params = init_params(cfm, torch.Generator().manual_seed(17), "cuda")
            packed = kfwd.pack_params(params, cfm)
            with torch.inference_mode(name.startswith("scann_loop") and "backward" not in name):
                saved[name] = launcher(name, cfm, x, packed, params)[1]()
        for name, cfm, x in (("scann_loop_wide_bf16", bf16(mp2018), wide_x),
                             ("scann_loop_tall_bf16", bf16(ptgp), tall_x)):
            params = init_params(cfm, torch.Generator().manual_seed(17), "cuda")
            packed = kfwd.pack_params(params, cfm)
            with torch.inference_mode():
                got = launcher(name, cfm, x, packed)[1]()
                cat = lambda ts: torch.cat([t.double().reshape(-1) for t in ts])
                floor = (cat(kloop.reference_loop_forward(params, x, cfm))
                         - cat(kloop.reference_loop_forward(f64_params(params), x, cfm))
                         ).abs().mean()
            saved[name] = {"pred": got[0], "ga": got[1], "floor": floor.cpu()}
        args = layer_inputs(np.random.default_rng(8), 8, 96, 96, mp2018.local_dim,
                            mp2018.num_head, True)
        narrow = layer_inputs(np.random.default_rng(7), 64, 96, 32, mp2018.local_dim,
                              mp2018.num_head, True)
        with torch.inference_mode():
            saved["local_attention_wide"] = [t.cpu() for t in kla._launch(*args)]
            # #5 on bfloat16 tensors, narrow and wide, and #1 in the bf16 operand mode
            for name, layer in (("local_attention_bf16", narrow),
                                ("local_attention_wide_bf16", args)):
                saved[name] = [None if t is None else t.cpu()
                               for t in kla._launch(*layer_cast(layer, torch.bfloat16))]
            qm9_16 = bf16(qm9_config())
            packed = kfwd.pack_params(init_params(qm9_config(), torch.Generator().manual_seed(17),
                                                  "cuda"), qm9_config())
            saved["scann_forward_bf16"] = launcher("scann_forward_bf16", qm9_16, qm9_x, packed)[1]()
        # #4's d256 builds at a fixed C = 2, f32 stash: the tall one at MP2018
        # (4, 96, 32), the wide one at (4, 80, 96), D = 256 (f32 and bf16), and
        # at (136, 132, 140), whose wide sub-chunk the plan may change
        for name, D, G, O, N in (("scann_loop_backward_tall_d256", 256, 256, 256, 32),
                                 ("scann_loop_backward_wide_d256", 256, 256, 256, 96),
                                 ("scann_loop_backward_tall_d256_bf16", 256, 256, 256, 32),
                                 ("scann_loop_backward_wide_d256_bf16", 256, 256, 256, 96),
                                 ("scann_loop_backward_wide_d136", 136, 132, 140, 96)):
            cfm = widened(mp2018, D, G, O)
            x = (synthetic_batch(np.random.default_rng(242), 4, 96, 32, n_atoms=cfm.n_atoms,
                                 min_atoms=20) if N <= 32
                 else wide_batch(np.random.default_rng(242), 4, 80, N, cfm))
            params = init_params(cfm, torch.Generator().manual_seed(17), "cuda")
            packed = kfwd.pack_params(params, cfm)
            if name.endswith("_bf16"):
                cfm = bf16(cfm)
            B, M = x["atomic"].shape[:2]
            y = torch.from_numpy(np.random.default_rng(243).normal(size=(B, 1))
                                 .astype(np.float32)).cuda()
            scratch = kloop.loop_backward_scratch(packed, cfm, B, M, N, 2, "f32")
            flat, pred = kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                                scratch, 2, stash="f32")
            saved[name] = {"pred": pred.cpu(), **{k: v.cpu() for k, v in
                                                  kbwd.grads_from_flat(flat, packed, cfm).items()}}
            if name in AB_FLOOR:
                saved[name]["floor"] = torch.tensor(bf16_grad_floor(params, x, y, cfm))
            del scratch, x
        # ptxas -v of every build of this checkout: (kernel, registers, spill
        # stores, spill loads), from the logs beside its cached libraries
        from scann_tpu_torch.kernels import _build

        saved["ptxas"] = out["ptxas"] = {
            name: [list(r) for r in _build.kernel_resources(name)]
            for name in _build.SOURCES + _build.SHAPE_SOURCES}
        torch.save(saved, out_path)
    out["card"] = card_line()
    print(json.dumps(out), flush=True)
    return 0


# Builds whose outputs --ab-compare holds within GRAD_RTOL x max rather than
# bit for bit: the tall #4, whose 64-row chunks sum the weight gradients in
# another order than a build with 32-row chunks, and the wide #4 (against a
# build with 32-row sub-chunks and the resident buffer), whose 64-row
# sub-chunks and atom blocks of 16 sum the weight gradients and the d(layer
# input) partials in another order; its forward pass sums in the order it
# did, so its pred is held bit for bit (AB_PRED_EXACT). In the bf16 operand
# mode that order flips bf16 roundings (1e-2 x max at MP2018), so the bf16
# wide #4 is held as phases 18-19 hold bf16 builds against each other: the
# mean distance within BF16_FLOOR x the f32-noise floor of its plain version
# (AB_FLOOR, the floor saved beside its outputs)
AB_PRED_EXACT = ("scann_loop_backward_wide", "scann_loop_backward_wide_bf16",
                 "scann_loop_backward_wide_n48", "scann_loop_backward_tall_d256",
                 "scann_loop_backward_wide_d256", "scann_loop_backward_tall_d256_bf16",
                 "scann_loop_backward_wide_d256_bf16", "scann_loop_backward_wide_d136")
AB_FLOOR = ("scann_loop_backward_wide_bf16", "scann_loop_backward_tall_d256_bf16",
            "scann_loop_backward_wide_d256_bf16")
AB_WITHIN = ("scann_loop_backward_tall", "scann_loop_backward_tall_bf16") + AB_PRED_EXACT
# The tall and wide #3 against a build before their redesign: the wide
# build's context sums each half of the neighbours, then adds the halves, so
# its outputs are held at the forward's RTOL / ATOL; the tall build's sums
# keep their order (held the same way, bit-equal in practice), and in bf16
# both as the bf16 #4 above (the mean distance within BF16_FLOOR x the
# f32-noise floor saved beside the outputs)
AB_FORWARD = ("scann_loop_wide", "scann_loop_tall")
AB_FORWARD_FLOOR = ("scann_loop_wide_bf16", "scann_loop_tall_bf16")
# The wide #5 against a build before its redesign: its context sums each half
# of the neighbours, then adds the halves, so its out and geometry are held
# at the forward's RTOL / ATOL and its attention at RTOL / ATTN_ATOL
AB_LAYER = ("local_attention_wide",)


def bf16_grad_floor(params, x, y, cfm):
    """The f32-noise floor of #4's plain version in ``cfm``'s operand mode
    (one-shot, dropout 0.1, seed 7): the largest mean distance of its
    gradients from the same function on f64 weights or on weights jittered
    by about one f32 ulp."""
    from scann_tpu_torch.kernels import scann_loop as kloop

    run = lambda q: kloop.reference_loop_train_grads(q, x, y, cfm, False, 0.1, 7)[1]
    flat = lambda g: torch.cat([g[k].double().reshape(-1) for k in sorted(g)])
    want = flat(run(params))
    return max((want - flat(run(q))).abs().mean().item()
               for q in [f64_params(params)] + [jittered(params, j) for j in range(JITTERS)])


def ptxas_differ(a, b):
    """The builds both ``ptxas -v`` maps (build -> [kernel, registers, spill
    stores, spill loads] a kernel, ``--backward-ab``'s ``ptxas``) have whose
    lines differ, or that have none. A kernel's name is taken without the
    hash nvcc gives each source's anonymous namespace, which changes with
    the source's path and text while the kernel does not."""
    norm = lambda rows: sorted([re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", str(r[0])),
                                *r[1:]] for r in rows)
    return [k for k in sorted(set(a) & set(b)) if not a[k] or norm(a[k]) != norm(b[k])]


def ab_compare(path_a, path_b):
    """``--ab-compare A.pt B.pt``: the outputs two ``--backward-ab`` turns
    saved, held bit for bit output by output (gradients by name), those of
    ``AB_WITHIN`` within GRAD_RTOL x max |A| of each gradient (``AB_FLOOR``:
    the mean distance within BF16_FLOOR x A's floor; pred at RTOL / ATOL,
    bit for bit in ``AB_PRED_EXACT``), those of ``AB_FORWARD`` at RTOL /
    ATOL, of ``AB_FORWARD_FLOOR`` within BF16_FLOOR x A's floor and of
    ``AB_LAYER`` at RTOL / ATOL (the attention at ATTN_ATOL), and the
    ``ptxas -v`` lines of every build both saved, equal kernel by kernel
    (``ptxas``; ``ptxas_differ`` names the builds that differ). Prints
    one JSON line, name -> equal (within the limit, beside the worst share
    of it as ``<name>_rel``, or the largest difference as
    ``<name>_max_abs``), and exits 1 on any difference."""
    a, b = (torch.load(p, weights_only=True) for p in (path_a, path_b))
    same, rels = {}, {}
    # ptxas -v of the builds both checkouts have, kernel by kernel
    pa, pb = a.pop("ptxas", {}), b.pop("ptxas", {})
    if set(pa) & set(pb):
        rels["ptxas_differ"] = ptxas_differ(pa, pb)
        same["ptxas"] = not rels["ptxas_differ"]
    for name in sorted(set(a) | set(b)):
        x, y = a.get(name), b.get(name)
        if name in AB_LAYER and isinstance(x, list) and isinstance(y, list):
            held, worst = len(x) == len(y), 0.0
            for i, (u, v) in enumerate(zip(x, y)):
                if u is None or v is None:
                    held = held and u is None and v is None
                    continue
                diff = (v - u).abs()
                atol = ATTN_ATOL if i == 2 else ATOL
                held = (held and bool((diff <= atol + RTOL * u.abs()).all())
                        and bool(torch.isfinite(v).all()))
                worst = max(worst, diff.max().item())
            same[name] = held
            rels[f"{name}_max_abs"] = worst
            continue
        if name in AB_FORWARD and isinstance(x, list) and isinstance(y, list):
            same[name] = len(x) == len(y) and all(errors(v, u)[2] for u, v in zip(x, y))
            rels[f"{name}_max_abs"] = max(errors(v, u)[0] for u, v in zip(x, y))
            continue
        if name in AB_FORWARD_FLOOR and isinstance(x, dict) and isinstance(y, dict):
            cat = lambda d: torch.cat([d[k].double().reshape(-1) for k in ("pred", "ga")])
            rel = ((cat(y) - cat(x)).abs().mean() / (BF16_FLOOR * x["floor"])).item()
            rels[f"{name}_rel"] = rel
            same[name] = rel <= 1.0
            continue
        if name in AB_WITHIN and isinstance(x, dict) and isinstance(y, dict):
            grads = {k: v for k, v in x.items() if k not in ("pred", "floor")}
            if x.keys() != y.keys():
                rel = float("inf")
            elif name in AB_FLOOR:
                flat = lambda g: torch.cat([g[k].double().reshape(-1) for k in sorted(grads)])
                rel = ((flat(y) - flat(x)).abs().mean() / (BF16_FLOOR * x["floor"])).item()
            else:
                rel = grad_errors({k: y[k] for k in grads}, grads)[0] / GRAD_RTOL
            rels[f"{name}_rel"] = rel
            pred = (torch.equal(y["pred"], x["pred"]) if name in AB_PRED_EXACT
                    else errors(y["pred"], x["pred"])[2])
            same[name] = rel <= 1.0 and pred
        elif isinstance(x, dict) and isinstance(y, dict):
            same[name] = x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
        elif isinstance(x, list) and isinstance(y, list):
            same[name] = len(x) == len(y) and all(
                (u is None and v is None) or (u is not None and v is not None and torch.equal(u, v))
                for u, v in zip(x, y))
        else:
            same[name] = False
    print(json.dumps({"bit_identical": same, **rels}), flush=True)
    return 0 if all(same.values()) else 1


def tall_table(out_path=None):
    """``--tall-table [OUT]``: #4's tall build against its narrow build at
    shapes both take, in turns (narrow, tall, tall, narrow; 5 timed launches
    a round, one-shot at dropout 0.1, the default cluster size, the f32
    stash where ``loop_stash_mode`` admits it, else recompute): MP2018 (64,
    96, 32); MP2018 (B, 200, 32), (B, 216, 32) and (B, 226, 32) at B = 16
    and 64, where the narrow plan falls to atom blocks of 16 or 8; and
    Pt/graphene (64, 128, 32). Prints a line a shape and one JSON line (with
    OUT, also saved there)."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from scann_tpu_torch.kernels import scann_backward as kbwd
    from scann_tpu_torch.kernels import scann_forward as kfwd
    from scann_tpu_torch.kernels import scann_loop as kloop
    from scann_tpu_torch.models.scann import init_params

    mp2018, ptgp = crystal_models()
    card = card_line()
    rows = []
    for name, cfm, B, M in (("MP2018", mp2018, 64, 96),
                            *[("MP2018", mp2018, B, M) for M in (200, 216, 226) for B in (16, 64)],
                            ("Pt/graphene", ptgp, 64, 128)):
        N = 32
        rng = np.random.default_rng(M + B)
        x = synthetic_batch(rng, B, M, N, use_ring=cfm.use_ring, n_atoms=cfm.n_atoms,
                            min_atoms=M // 2)
        packed = kfwd.pack_params(init_params(cfm, torch.Generator().manual_seed(0), "cuda"),
                                  cfm)
        y = torch.from_numpy(rng.normal(size=(B, 1)).astype(np.float32)).cuda()
        mode = kloop.loop_stash_mode(cfm, B, M, N)
        scratch = [kloop.loop_backward_scratch(packed, cfm, B, M, N, stash=mode, tall=t)
                   for t in (False, True)]
        tall_ms, narrow_ms = in_turns_ms(
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch[0], stash=mode),
            lambda: kloop._launch_backward(packed, x, cfm, y, None, True, False, 0.1, 7, 0,
                                           scratch[1], stash=mode, tall=True), 5, 5)
        del scratch
        _, P = kbwd.grad_layout(packed)
        flops = kloop.loop_backward_flops(cfm, B, M, N)
        bound, by, _ = bound_ms(flops, tensor_bytes(x.values(), weights(packed)) + 4 * B
                                + 4 * (P + B), kbwd.backward_fp32_flops(cfm, B, M, N))
        row = {"shape": [name, B, M, N], "cluster": kloop.cluster_size(B),
               "schedule": mode or "recompute", "narrow_ms": narrow_ms, "tall_ms": tall_ms,
               "narrow_plan": kloop.loop_backward_memory_plan(cfm, M, N)[:2],
               "tall_plan": kloop.loop_backward_memory_plan(cfm, M, N, tall=True)[:2],
               "bound_ms": bound, "bound_by": by}
        rows.append(row)
        print(f"tall against narrow #4 at {name} B={B} M={M} N={N}, C={row['cluster']}, "
              f"{row['schedule']} (timed in turns: narrow, tall, tall, narrow): tall "
              f"{tall_ms:.4f} ms (chunk atoms, block {row['tall_plan']}), narrow "
              f"{narrow_ms:.4f} ms ({row['narrow_plan']}), {100 * (tall_ms / narrow_ms - 1):+.1f}%"
              f"; bound {bound:.4f} ms by {by}  [{card}]", flush=True)
    out = {"tall_against_narrow": rows, "card": card}
    print(json.dumps(out), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--backward-ab"]:
        sys.exit(backward_ab(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--ab-compare"]:
        sys.exit(ab_compare(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--tall-table"]:
        sys.exit(tall_table(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--phase13-rank"]:
        rank, world, coordinator, spec_path, out_path, t_spawn = sys.argv[2:8]
        sys.exit(phase13_rank(int(rank), int(world), coordinator, spec_path, out_path,
                              float(t_spawn)))
    if sys.argv[1:2] == ["--phase13-serve"]:
        spec_path, out_path, t_spawn = sys.argv[2:5]
        sys.exit(phase13_serve(spec_path, out_path, float(t_spawn)))
    sys.exit(main())
