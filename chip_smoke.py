#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, one line or more each; any failure
exits non-zero and no failure is caught:

  1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions; the
     CUDA kernels are built from ``src/repro_torch/kernels/csrc`` (build time
     printed).
  2. kernels: each CUDA kernel against its plain PyTorch version on the card,
     bit-equal, at the shapes of the main path (mnist_mlp leaf ``l0.w``) and
     at VGG16's 512x512x3x3 leaf, with duplicates, -1 padding, out-of-range
     entries and the order-sensitive triple [1, 2^-24, -1]; the scatter
     also at one tree group's ``width + 1`` buffer of tree_quick's ``l0.w``
     (two thirds of the slots at the dump slot, +0.0) and on
     correctness-only inputs (one tile, a position with 12,000 non-zero
     entries, all zeros, +-inf and NaN, n = 0, size = 1, odd sizes, n below
     a chunk, more than 8192 tiles), its two passes timed as one call in a
     CUDA graph with the scratch allocated outside it; the bit-pack
     kernels at every width 1..32, at the codec path's shapes one segment
     at a time (5 rows, k = 7,880 at 18 and 8 bits; VGG16's k = 60,199 at
     22 and 1 bit) and as the two-segment leaf launches the codec path
     makes (18 + 8 bits, 22 + 1 bit; one launch a call); median times from
     CUDA events beside the bound and the library call; the pair-mask
     kernel's round launch at mnist_mlp's 4 leaves and VGG16's 54 (5
     clients, the protocol's matrices, one client dropped): every leaf's
     masks, then every leaf's recovery streams, one launch each, bit-equal
     to the segmented plain version and to the per-leaf flat launches,
     the raw launch timed in a CUDA graph beside the round function, the
     plain version and the bound; the flat per-pair call (one segment) at
     mnist_mlp's ``l0.w`` and VGG16's 512x512x3x3 (15 pairs); the CUDA
     kernels and host-to-device copies of one round's mask path
     (``torch.profiler``); ``thgs_sparsify`` and ``mask_prng_apply``
     bit-equal (as bits) at VGG16's largest leaf (f32 and bf16), mnist_mlp's
     l0.w and odd sizes,
     with ties at f32(0.1), +-inf accumulators, both signs, three (p, q)
     and the uint32 -> f32 rounding probes, then driven through ``ops`` over
     every leaf of mnist_mlp and VGG16 (counts reset before, read after)
     and timed cold (raw launches in a CUDA graph over buffer sets larger
     than L2) beside the bound, the wrapper and the plain version.
  3. main path: ``table2_quick`` (mnist_mlp 784-200-10 at full width, 12
     rounds of THGS + sparse-mask secure aggregation) through
     ``repro_torch.sim.Simulation`` on the card, after a one-round warm-up;
     launch counts reset just before and read just after (the pair-mask
     kernel once a round: 12); the paper-accounting upload ratio and the
     accuracy checked against the reference's numbers; round 0's ``l0.w``
     encode and decode replayed on the CPU with the plain versions, bit-equal.
  4. recovery: ``secagg_quick`` (dropout 0.25) on the card, the pair-mask
     kernel launched once a round and twice a dropout round (masks, then
     recovery streams, of every leaf); a dropped round's decoded aggregate
     held against the survivors' unmasked weighted sparse sum computed with
     the plain versions.
  5. full-size model: cifar_vgg16 on cifar10 under the table2 protocol,
     2 rounds (the 54 leaves' masks in one launch a round: 2).
  6. codecs: ``codec_sweep_quick`` (the table2 protocol without secagg, one
     arm per wire codec f32/int8/int4/1bit, 12 rounds each) on the card;
     counts reset before the sweep and read after it (48 launches of each
     bit-pack kernel per quantized arm, one a leaf for both of its wire
     streams: 144 a sweep); each arm's upload under both
     accountings against the f32 arm, its accuracy and launches; round 0's
     ``l0.w`` replayed on the CPU with the plain versions: bit-equal for
     int8/int4, within the 1bit scale tolerance (4 ulp) for 1bit; the
     CUDA kernels of one ``codec_wire_roundtrip`` call (``torch.profiler``)
     and its time.
  7. DP: ``dp_quick`` (secagg, dropout 0.25, clip 1, z 0.6) and the four
     arms of ``dp_frontier_quick`` on the card: the composed epsilon of each
     arm against the reference's (40.1; 89.7 / 33.7 / 14.1), a dropout
     round's decoded sum against the survivors' unmasked noised sum
     (64 * 2^-24), and the off arm bit-identical to the same run with an
     inactive ``DPConfig()``.
  8. tree: ``tree_quick`` (secagg, dropout 0.25, 3 sub-aggregators) on the
     card: every leaf's tree decode bit-equal to the flat decode of the same
     streams, survivors [5, 6, 4, 4, 4, 5, 5, 5], upload 6.3% +- 0.5 pt,
     accuracy against the port's CPU run and the reference's 0.941, 96
     scatter launches, 8 + 7 pair-mask launches (one a round, one more a
     dropout round; ``dp_quick`` likewise); then 2 VGG16 rounds under the
     tree protocol (G = 3), each leaf bit-equal to flat, the
     2,359,296-element leaves also over an uneven split.
  9. async: ``async_quick`` (FedBuff buffer 4, max staleness 3) on the card:
     the reference's staleness vectors, upload 7.0% +- 0.5 pt, accuracy;
     then an all-fresh buffer through ``run_async_update`` bit-equal to
     ``run_round``.
 10. flash: the tensor-core instructions in the built flash library's SASS
     (``cuobjdump -sass``: HGMMA in the bf16 instances, TF32 HGMMA in every
     f32 instance, which runs both products as three TF32 passes); the
     flash-attention kernel against its plain version on the card (2e-5 in
     f32, 2e-2 in bf16; max abs error and error relative to max |plain|) at
     Yi-6B's prefill shape (B 4, T = S = 1024, 32 heads, 4 kv heads, hd 128,
     bf16, causal), a 4096-token prompt, f32, ragged tails (24, 1000), MQA, a
     256-token window, and in bf16 hd 64, causal=False, T > S with rows that
     have no key, T and S not multiples of 128, T != S, a window at hd 64,
     and three needle cases (V = 1000 at a future key, at a key just outside
     the window, and in the memory past S), where the rows that must not see
     the needle are checked on their own; head widths 80 and 112 (P V padded
     to 128 on the tensor cores) at HuBERT-XLarge's encode (B 4, T = S =
     1024, 16 heads, non-causal) and Zamba2-7B's shared block (B 4, T = S =
     1024, 32 heads, causal), in f32, with ragged tails and needles at each
     width; Yi-6B in f32 at ``[lm]``'s parity prompt (B 1, T 256) and at its
     prefill shape, and f32 at T > S, T != S, a window and three needles;
     for Yi-6B's two bf16 rows, the two hd-80/112 model rows and every f32
     row of T = S with no window, the raw launch time beside the bound (the
     flops of the pairs the mask keeps; f32 at a third of the TF32 rate, and
     at the CUDA cores' f32 rate beside it), the plain version and
     ``scaled_dot_product_attention`` as the library yardstick: its default
     call, then each backend pinned in turn (time and error, or refused),
     and which one the default took.
 11. lm: Yi-6B at full width (32 layers, d_model 4096, bf16, 12.1 GB of
     random weights drawn on the card from seed 0) served by
     ``InferenceServer(LMAdapter(max_batch=4, prompt_len=1024, n_new=16))``
     under ``LoadGenerator``: 8 requests, 0 errors, 16 tokens each in the
     vocabulary, 32 flash launches per prefill (counts reset before and read
     after), a valid ``repro.serve/v1`` document; prefill and decode times,
     tokens/s, peak memory; then the same weights served over a grid
     (``launch/tp_serve.py`` through ``launch/serve.py``'s steps, ``(data
     1, model 2)`` with both positions on ``cuda:0``): a prefill of 4 x
     1,024 tokens into 1,048 slots (counts reset before, read after: 64
     flash launches, once a layer a position, each new flash shape against
     the plain version), the parameter bytes placed against ``param_specs``,
     the state's against ``input_pspecs`` and the K/V (274,726,912 B) and
     the relayout's moved bytes (134,217,728 B) against hand counts, the
     prefill logits and 16 teacher-forced decode steps against the one
     card's within ``FAMILY_TOL`` * max(1, max |logit|), the greedy tokens
     (a differing token a near tie of the one card's top two), two decodes
     from one cloned state bit-equal, times and peak beside the one card's;
     then ``long_500k``'s decode, one row folded over ``(data 2, model 2)``
     on ``cuda:0`` (every data group runs the row; each cache split over
     the four cells): (a) the same weights in the long-context variant
     (window 8,192) at 524,288 slots, 8 teacher-forced steps from a seeded
     fill of 262,140 slots (across cell 1 | cell 2) on the one card first,
     its cache freed, then on the grid from the same fill
     (``tp_serve.place_state``): parameter bytes against ``param_specs``,
     state bytes against ``input_pspecs`` under the rewritten rules and
     the hand count 34,359,738,880, logits within ``FAMILY_TOL`` * max(1,
     max |logit|) of the one card's, greedy tokens, decode ms a step beside
     the one card's with a profiled step of each, peak within 75 GiB; (b)
     Yi-6B at 2 layers, a 3,068-token prompt into 4,096 slots (8 flash
     launches, once a layer a cell, each shape against the plain version),
     state bytes, 8 decode steps against the one card's, two decodes
     bit-equal; (c) one decode attention layer in f32 (TF32 off) over the
     four cells of 4,096 slots with a window of 512 straddling the data
     groups' boundary, against ``decode_self_attention``
     (``SERVE_TP_TOL``, ``SERVE_TP_CACHE_TOL``); then Yi-6B at full width
     and 2 layers in f32 (TF32 off), one 256-token prompt and 4 new
     tokens, on the card against the CPU's plain path: logits within 2e-4
     and equal tokens.
 12. resume: ``table2_quick`` killed by a round hook after round 6 and
     resumed to 12 (a checkpoint every 6 rounds under ``build/smoke``), then
     ``async_quick`` killed after round 4 of 8: ledger entries, accuracies,
     losses, final params, residuals (and the async version ring) bit-equal
     to an uninterrupted run in this process; counts reset before the
     killed leg and read after the resumed one (the pair-mask kernel 12
     times over the two legs of table2_quick); each killed checkpoint is
     also resumed by ``python -m repro_torch.sim --ckpt-dir`` in a fresh
     process, whose ledger, accuracies, losses and final checkpoint must be
     bit-equal to the same uninterrupted run; then VGG16 under the table2
     protocol, 2 rounds: two serial engine runs, each started with cuDNN
     left non-deterministic and autotuning (the engine must set
     deterministic cuDNN itself), bit-equal to each other, and the run
     killed after round 1 and resumed, bit-equal to them (2 mask launches
     over both legs); VGG16's local SGD timed with and without
     deterministic cuDNN, in turns; then one VGG16 checkpoint (its params
     and 10 clients' residuals, about 650 MB on disk): save and restore
     times, restored bit-equal.
 13. serve: ``python -m repro_torch.serving --preset table2 --qps 1000``
     through its ``main()`` on the card (training in the main thread, the
     server, the load generator and the checkpoint watcher in threads;
     counts reset before and read after): 0 errors, at least one swap, the
     final published step active, a valid ``repro.serve/v1`` document, at
     least 200 requests served before training ended; served count,
     latency p50/p99, swap pauses and staleness printed; then
     one VGG16 publish (14,728,266 parameters) staged through the
     ``CheckpointWatcher`` while 120 large matmuls sit queued on the
     default stream: host load ms, side-stream copy ms, swap pause, the
     queued work still running when the staging ended (it waits on its own
     stream's event only), logits after the swap bit-equal to a cold
     restore.
 14. sharded: the client-sharded round on shards that share the card
     (``ClientsMesh((cuda:0,) * n)``; counts reset before each run, read a
     round at a time by a round hook). The pair-mask kernel's row launch (a
     shard's rows of the seed matrix, ``rows = C_loc < peers = C``, no
     mirror) at mnist_mlp's 4 leaves (C 6, shards of 2 and 3) and VGG16's
     54 (C 5, one client a shard), bit-equal to its plain version and to
     the mirrored round launch's rows, timed beside them. The reference's
     parity configuration (mnist_mlp at full width, 12 clients, cohort 6,
     3 rounds, dropout 0.4, weights by data count, mask ratio 0.02, seed 1)
     over 2, 3 and 6 shards against the serial run: params, every client's
     residuals, ledger entries and accuracies bit-equal, at least one
     dropout round, each round's pair-mask launches = shards (+1 in a
     dropout round) and scatter launches = leaves; ``tree_quick`` over 3
     shards, ``dp_quick`` over 2 and ``codec_sweep_quick``'s int8 arm over
     5 (20 pack and 4 unpack launches a round) likewise, every leaf's
     sharded encode/decode fed the serial run's deltas bit-equal to the
     serial one. The one-client shard's local SGD with and without its
     duplicated row, at the int8 arm's and VGG16's first round: bit-equal
     to the cohort's batch with it, timed beside the serial cohort's call;
     the int8 arm's (mnist_mlp) local SGD bit-equal to
     ``torch.func.grad_and_value`` inside ``vmap``.
     VGG16's first local SGD step, client 0 in a vmapped call of 5 against
     2 and 1 (duplicated): each layer's output and each gradient leaf,
     printed under the plain ops (a grouped convolution, the BN formula
     vmapped) with ``torch.func.grad`` inside ``vmap``, as the port ran
     them before, under the per-client ops with it, and under the port's
     per-client ops with autograd over the vmapped forward, which must be
     bit-equal. VGG16 under the table2
     protocol, 2 rounds over 5 shards, under deterministic cuDNN: two
     serial runs bit-equal; the per-leaf sharded encode/decode fed the
     serial deltas bit-equal; the sharded run bit-equal to the plain
     serial run (params, residuals, ledger, accuracies; where not, the
     first round and leaf that differ are named). Round wall times, serial
     against sharded, and the bytes the stream gather and the residual
     return copy a round are printed.
 15. bench: ``python -m repro_torch.bench --quick --out`` through its
     ``main()`` on the card, in a fresh process as the baselines were made
     (the ``round``, ``agg``, ``cohort`` and ``serve`` suites; that
     process's launch counts): the document valid, its env
     naming the card and the power limit ``nvidia-smi`` gives, every
     suite's entry names equal to the reference's quick names, each of the
     scatter, pair-mask, both bit-pack and the flash kernels launched; the
     run gated against the committed ``BENCH_torch_*.json`` (exit 0, at
     least one entry compared); then, at the suites' ``--quick`` shapes and
     on their inputs (launches not counted): ``pair_mask`` for every
     ordered pair of the agg cohort, ``client_masks`` and ``encode_leaf``
     for each of its clients bit-equal to the same calls on the CPU; the
     agg micro's 64-pair flat mask launch, the cohort streams' flat and
     tree decodes (C = 64, 256, 1,024) and the codec packs and unpacks at
     8 x 163 fields (int8, int4, 1bit widths) bit-equal to their plain
     versions on the same card tensors; the loop round's dense sum
     bit-equal to the CPU's and within ``LOOP_BATCHED_ATOL`` of the
     batched round's; the flash kernel's f32 instance at the reduced
     Yi-6B prefill (B 4, T 16, 4 heads, 2 kv, hd 64) within 2e-5 of its
     plain version; then ``--csv --only table1,table2,fig1,fig3 --quick``
     (the paper-table drivers on the card) and its rows printed.
 16. families (run after 11): every other LM family at full width, one
     config at a time and freed before the next, bf16 weights drawn on the
     card from seed 0: DeepSeek-MoE-16B (8 of 28 layers) and
     Llama-4-Scout-17B-16E (2 of 48, top-1) at B 4, Llama-3.2-Vision-90B (10
     of 100 layers: 2 super-blocks, 1,024 seeded image embeddings) at B 2,
     Zamba2-7B (all 81) and xLSTM-125M (4 of 12) at B 4, each a 1,024-token
     prompt and 16 greedy tokens; HuBERT-XLarge (all 48) encodes 4 x 1,024
     seeded frames. Counts reset before the first prefill and read after it:
     flash launched once per attention layer (cross-attention included; the
     hybrid's shared block once a super-block), and the first flash call of
     each shape in that prefill within 2e-2 of the plain version on its own
     inputs; two more prefills bit-equal to it; finite logits and tokens in
     the vocabulary; the reference's contract (forward over T + 1 against
     prefill(T) + one decode step) within ``FAMILY_TOL`` in bf16, MoE held
     where the reference's test holds it (no token dropped, f32), its bf16
     gap at the configured capacity printed; the last MoE layer of that
     prefill, at the configured capacity in f32, on the card against the
     same inputs on the CPU (equal experts and slots, some token dropped, y
     within ``MOE_CAP_ATOL``); the encoder's decode step raises. Prefill and
     decode times, peak memory, one profiled prefill and decode step.
     Right after the Llama-3.2-Vision, Zamba2, xLSTM and HuBERT cells, each
     served over the grid as in phase 11 on that cell's weights and depth
     (``serve_grid_family``): B x 1,024 tokens (frames; the VLM with seeded
     image embeddings) into 1,040 slots, 520 a position, and 4
     teacher-forced decode steps (the encoder's grid decode raises): flash
     once an attention layer a position (20, 18, 0 and 96 launches; the
     VLM's cross layers and the encoder non-causal), each new flash shape
     against the plain version, the bytes placed (parameters by
     ``param_specs``, the state by ``input_pspecs``) and the self K/V,
     cross K/V (split by image token), recurrent states (whole on both
     positions) and relayout bytes against hand counts, the logits within
     ``FAMILY_TOL`` * max(1, max |logit|) of the one card's, greedy tokens,
     two decodes bit-equal, times and peak beside the one card's.
     Then DeepSeek-MoE-16B (8 layers) served over the grid as in phase 11
     (16 flash launches, 4 decode steps), in bf16 with its logits printed,
     not held (a bf16 ulp of the router's input moves a top-6 near tie of
     64 experts, so rows route otherwise), and in f32 (TF32 off) held
     within ``SERVE_TP_MOE_F32_TOL`` (a row whose token goes to other
     experts in some layer is reported from then on, not held); and the
     layer checks: one decode attention layer at full width in f32 (TF32
     off) over the grid with a cache of 4,096 slots split 2 x 2,048, against
     ``decode_self_attention`` on the whole cache, the new slot on position
     0, on position 1, at slot 2,047 and 2,048, for Yi-6B (GQA 32 / 4),
     Granite-20B (MQA 48 / 1), Llama-4-Scout's width with a window of 512
     and Yi-6B with an int8 cache (``SERVE_TP_TOL``,
     ``SERVE_TP_CACHE_TOL``); and the family layers at full width in f32
     over the grid against their one-device functions, output and state
     (``SERVE_FAMILY_TOL``): the VLM's cross read over 1,024 image tokens
     split 2 x 512, a Zamba2 mixer and an xLSTM-125M sLSTM and mLSTM cell
     each 4 decode steps from a 256-token prefill, and the tied head's
     logits against ``final_norm(h) @ embed.T``.
 17. train (run after 16): LM training, which launches no kernel (counts
     reset and read: no flash launch; attention is ``attend_chunked``).
     Yi-6B at full width and 1 layer in f32 (TF32 off), B 2 x T 2048
     (two attention chunks): loss, every gradient leaf and the params
     after one ``make_dense_train_step`` step on the card against the CPU
     (``TRAIN_LOSS_TOL``, ``TRAIN_GRAD_REL``, ``TRAIN_PARAM_TOL``); the
     gradients without the per-block and per-chunk checkpoints bit-equal
     to those with them; two steps from one state bit-equal; n_micro 2
     against 1 within ``TRAIN_MICRO_REL``. The same model over ``data 2``
     on ``[cuda:0, cpu]`` (``launch/fsdp.py``), B 2 x T 256: the bytes on
     the card after placement (the caching allocator's requested bytes;
     ``memory_allocated`` counts an unsplit cached block whole, under 1 MiB
     more a tensor) equal to ``param_specs``' prediction (the
     ``embed`` table whole, every other matrix halved), one step within the
     card-vs-CPU tolerances of the one-card step at n_micro 2. Yi-6B whole
     in bf16 over two explicit groups on ``cuda:0``, B 4 x T 4096: one step
     whose loss and params are bit-equal to the n_micro 2 step 1 below,
     its peak at most that run's plus a gathered block and ``lm_head``.
     Tensor parallelism (``launch/tp.py``): (g) the same 1-layer f32 model
     over ``(data 1, model 2)`` on ``[cuda:0, cpu]``, B 2 x T 256: the
     bytes on the card after placement equal to ``param_specs``'
     prediction, one step within the card-vs-CPU tolerances of the same
     grid on ``[cuda:0, cuda:0]``; (f) Yi-6B whole in bf16, B 4 x T 4096 as
     n_micro 2, over ``(data 1, model 2)`` with both positions on
     ``cuda:0``: the bytes placed, one step against the one-card step
     (``TP_LOSS_TOL``, ``TP_PARAM_TOL``, ``TP_MOVED_SHARE``), two steps
     from one state bit-equal, step ms, tokens/s, peak. (h) DeepSeek-MoE-16B
     (4 of 28 layers) the same way, expert-parallel, after one layer
     against ``moe.apply_moe``. (i) Zamba2-7B (9 of 81 layers: 9 Mamba2
     mixers and the shared block), bf16, B 2 x T 4096, and (j) xLSTM-125M
     (2 of 12 layers: an sLSTM, an mLSTM), bf16, B 2 x T 512, head-split
     over ``(data 1, model 2)`` on ``cuda:0``, after a layer check of the
     mixer and of each cell at full width (B 2 x T 256, f32 and bf16,
     against the one-device block within ``TP_LAYER_TOL``): the bytes
     placed, the weight bytes read across positions against a hand count
     (``ssm_across``, ``xlstm_across``; the parent's ``on_lead`` beside),
     no whole output scattered from position 0, one step against the
     one-card step (``TP_SSM_*``, ``TP_XLSTM_*``), two steps bit-equal,
     peak <= ``TP_PEAK_GIB``. Then Yi-6B at
     full width and
     depth in bf16 (seed 0): 3 SGD steps (5 before the tensor-parallel
     cases) at lr 0.01 on one batch of
     ``make_lm_tokens(64000, 4, 4096, seed=0)`` as the dry run's
     microbatch rule splits it (2 of 2 rows), then one profiled step: every
     loss finite and the last below the first, every gradient leaf of the
     first step finite and not all zero; step ms (median of steps 2-3),
     tokens/s, peak memory, the step's floating-point operations against
     989 TFLOP/s, busy share and top kernels. Then one step of every config
     of phase 16 at its depth and batch, bf16, T 1,024 (frames, bf16 image
     embeddings): finite loss and gradients, no all-zero gradient leaf (the
     MoE experts no kept assignment reached named), a second step's ms
     and peak memory; and each family at ``configs.reduced`` width in f32
     on the card against the CPU, within the CPU parity tests'
     tolerances.
 18. fl_train (run after 17): the federated LM train step
     (``launch/train.py::make_fl_train_step``) on the multi-pod layout (pod
     2 x data 16 x model 16: 2 participants of 256 blocks), the dry run's
     THGS (s0 0.01, alpha 0.9, s_min 0.001) and mask ratio 0.01. (a) Yi-6B's
     ``embed`` leaf and ``blocks.mlp.wi_gate``'s slice 0 at full width on
     seeded inputs: each participant's keyed masks and blocked encode and
     the decode bit-equal card (the scatter kernel) vs CPU (the plain
     fold); the kernel at the embed decode bit-equal to its plain version,
     timed beside its bound and ``index_add_``, its scratch printed. (b)
     Yi-6B at 1 layer in f32 (TF32 off), B 2 x T 512: one v1 step card vs
     CPU (loss within ``FL_LOSS_TOL``; params within ``FL_PARAM_TOL``, at
     most ``FL_MOVED_SHARE`` of the elements apart: a top-k flip moves an
     element by its whole update). (d) Placement, (b)'s inputs and state:
     (i) every position on ``cuda:0`` through a device array, bit-equal to
     (b)'s one-device step (params, residuals, loss, streams); (ii) (b)'s
     CPU run; (iii) pod 0 on ``cuda:0``, pod 1 on the CPU, the parameters
     on ``cuda:0`` (counts reset, one step, counts read: one scatter launch
     a unit): participant 0's streams and residual rows bit-equal to (i)'s
     and on the card, participant 1's to (ii)'s and on the CPU, the CPU
     replica bit-equal to the step's start, the params bit-equal to (i)'s
     step's exchange fed participant 0's card and participant 1's CPU
     gradients, and within ``FL_PARAM_TOL`` / ``FL_MOVED_SHARE`` of (i)'s;
     a v2 step on (i) and on (iii): finite, gradients on the participants'
     devices, the masks cancel, (iii) within ``FL_PARAM_TOL`` of (i).
     (c) Yi-6B whole (32 layers, bf16, seed 0), B 4 x T 4096 (2 rows a
     participant), lr 0.01, server_lr 1, every position on ``cuda:0`` by
     a device array: counts reset, 2 steps (3 before the tensor-parallel
     cases; the last with its parts timed), counts read: 229 scatter
     launches a step (every decode); a profiled third step (busy share, the
     scatter's device
     time); every loss finite, every leaf's aggregate non-zero, every
     matrix leaf changed (changed elements printed per leaf), residuals
     finite and non-zero, the masks cancel on ``lm_head`` (the masked
     exchange against the same streams with the mask values taken off,
     within ``FL_CANCEL_TOL``); step ms, tokens/s, peak memory, the
     exchange's entries against dense. (e) One participant over its data
     positions (``launch/fsdp.py``), Yi-6B at 1 layer in f32, B 4 x T 128:
     (i) each participant's data 0-7 and 8-15 as two explicit groups on
     ``cuda:0``, v1 and v2 steps bit-equal to the one-device step at
     n_micro 2 (params, residuals, loss, streams); (ii) data 0-7 of each
     pod on ``cuda:0``, 8-15 on the CPU: every chunk, residual chunk and
     stream on its device, each group's loss and gradients bit-equal to
     ``value_and_grad`` of the one-device model of its device on its rows
     (no deterministic flag: the embed gather's backward folds in token
     order),
     params within ``FL_PARAM_TOL`` of (i) with at most ``FL_MOVED_SHARE``
     of the elements apart, one scatter launch a unit (counts reset and
     read around the v1 step; they join the kernel table's), and a v2 step
     whose masks cancel. (f) Tensor parallelism (``launch/tp.py``): Yi-6B
     whole in bf16, B 4 x T 4096, two pods each ``(data 1, model 2)`` with
     both positions on ``cuda:0``: one v1 step (counts reset and read: 229
     scatter launches; they join the kernel table's) against the
     one-device v1 step on the same (2, 1, 2) layout (params within
     ``FL_TP_PARAM_TOL``, at most ``FL_MOVED_SHARE`` apart), then a v2
     step at the same size on the same grid, encoded in place (each cell
     its own block), against the one-device v2 step (the same tolerances;
     one scatter launch a leaf, checked apart; masks cancel; no byte
     gathered on an aligned leaf; peak <= ``FL_PEAK_GIB``); every loss,
     leaf and residual finite, every matrix leaf moved; step ms, tokens/s,
     peak. (g) DeepSeek-MoE-16B (4 of 28 layers), v2 then v1 on (2, 1, 2)
     against the one-device steps. (h) [train] (i)'s Zamba2-7B, v2 on (2,
     1, 2), head-split, against the one-device v2 step: one scatter launch
     a leaf (counts reset and read; they join the kernel table's), the
     masks cancel, no byte gathered on an aligned leaf, the weight bytes
     read across positions against the hand count, params within
     ``FL_TP_PARAM_TOL`` with at most ``FL_MOVED_SHARE`` apart. (i)
     ``table2_fedavg_quick`` with dense secure aggregation, 2 rounds on the
     card and the CPU: equal ledgers.
 19. selectors (run after 15): the 'sampled' and 'local' THGS selectors.
     (a) At VGG16's 512x512x3x3 leaf (k 60,199) and Yi-6B's ``embed``
     (262,144,000 elements, its Eq. 1 k under the dry run's THGS) on a
     seeded accumulator: 'sampled' indices card vs CPU bit-equal, exact and
     sampled selection timed in turns with CUDA events,
     ``sparsify.sparsify_leaf`` card vs CPU bit-equal, ``densify`` of the
     stream with duplicates through one scatter launch, bit-equal to the
     plain fold. (b) ``table2_quick`` under 'exact', 'local' and 'sampled'
     (counts reset before each run, read after): 'local' bit-equal to
     'exact' (params, residuals, ledger); 'sampled' launches the scatter 48
     and the masks 12 times, its upload ratio and accuracy within the main
     path's limits. (c) VGG16 under the table2 protocol, 2 rounds, in
     turns exact, sampled, sampled, exact: round and encode ms (the device
     synchronized around each leaf's encode); round 0's sampled encode of a
     512x512x3x3 leaf replayed on the CPU from the same accumulators,
     bit-equal. The first sampled runs' launches join the kernel table's.
 20. secagg_demo (run after 19): the secure-aggregation walkthrough
     (``python -m repro_torch.secagg.demo``, the reference's
     ``examples/secure_aggregation_demo.py``: n 4096, banks 0-2, seed 2024)
     on the card, counts reset just before and read just after (the
     pair-mask kernel for the encode's masks and the recovery masks, the
     scatter for each of the three decodes), then on the CPU: its facts
     printed; the streams (indices and values) and the three decoded sums
     (round, no recovery, recovery) card == CPU bit-equal; the exactness
     and recovered errors below ``DEMO_ERR_TOL``; the integer facts (slots,
     masked slots, shares, bytes) equal. The scatter at the round decode's
     stream and the flat pair-mask call at the encode's 6 pairs against
     their plain versions, timed; the launches join the kernel table's.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. ``--only flash`` runs phases 1 and 10
alone, does not require HGMMA or TF32 instructions, and prints no
result line (the kernel's times on one tree, to compare two trees in one
call); ``--only
pack`` runs phase 1, the bit-pack part of phase 2 and the round-trip probe
of phase 6 the same way (on a tree without segmented launches, the parent
of that design, a leaf pair is timed as its two single launches); ``--only
masks`` runs phase 1, the pair-mask kernel's round and flat rows of phase 2
and the mask path probe the same way (on the parent of the round launch, a
round is timed as its per-leaf flat launches); ``--only sharded`` runs
phases 1 and 14, ``--only bench`` phases 1 and 15, ``--only families``
phases 1 and 16, ``--only train`` phases 1 and 17, ``--only fl_train``
phases 1 and 18, ``--only selectors`` phases 1 and 19, ``--only
secagg_demo`` phases 1 and 20, ``--only tp`` phase 1 and the
tensor-parallel cases (the serving grid's layer checks, its ``long_500k``
cases (a) to (c) and its Yi-6B and DeepSeek-MoE-16B cases of phases 11
and 16, ``[train]`` (f) to (j), ``[fl_train]`` (f), (g), (h)). Phases 17
and 18 run their CPU reference steps of Yi-6B at 1 layer (``[train]``'s
parity, ``[fl_train]`` (b)) on a worker thread while the card trains, and
join them before their checks. Without a
CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor-core rate
MASK_OPS_PER_SLOT = 25         # integer ops of one pair-mask slot (two mix32
                               # chains, mod, shift, convert, 2 mul + add),
                               # counted at the f32 rate: the data sheet
                               # gives no int32 rate
PACK_OPS_PER_FIELD = 4         # mask, shift, OR, offset of one packed field
                               # (both directions), at the f32 rate
ONE_BIT_REL = 4 * 2.0 ** -23   # the 1bit scale: a mean summed in another
                               # order on the card than on the CPU


def bound(bytes_: int, ops: int,
          rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bits_equal(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def events_ms(fn, *, reps: int = 5, inner: int = 20,
              warmup: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call, in ms (after ``warmup`` calls). Host time between
    launches is counted when the host is the slower side."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(launch, *, reps: int = 7, inner: int = 50) -> float:
    """Device time per call of ``launch``, in ms: ``inner`` calls captured in
    one CUDA graph, the replay timed with CUDA events (median of ``reps``),
    so no host time is counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


# ------------------------------------------------------------------ phase 2
def scatter_inputs(n: int, size: int, seed: int, *, adversarial: bool):
    """A main-path-like stream of ``n`` slots into ``size`` positions:
    random indices (duplicates occur), values on the mask grid plus small
    gradients. ``adversarial`` adds -1 padding, indices >= size, exact
    cancellations (-0.0 partials) and the order-sensitive triple."""
    import numpy as np

    rs = np.random.RandomState(seed)
    idx = rs.randint(0, size, size=n).astype(np.int32)
    vals = (rs.randint(-2**23, 2**23, size=n) / 2.0**23
            + rs.randn(n) * 1e-3).astype(np.float32)
    hot = idx[: max(1, n // 100)]
    idx[n // 2: n // 2 + len(hot)] = hot          # forced duplicates
    if adversarial:
        pos = np.arange(0, n, 97)
        idx[pos[: len(pos) // 2]] = -1            # wrapper-style padding
        idx[pos[len(pos) // 2:]] = size + (pos[len(pos) // 2:] % 7)
        p0 = int(idx[1])
        idx[idx == p0] = (p0 + 1) % size
        for slot, v in zip((n // 5, n // 2 + 1, n - 3),
                           (1.0, 2.0 ** -24, -1.0)):
            idx[slot], vals[slot] = p0, v         # [1, 2^-24, -1] in order
        idx[3], vals[3] = (p0 + 2) % size, -0.0   # a lone -0.0
        q0 = int(idx[5])
        idx[7], vals[7] = q0, -vals[5]            # exact cancellation
        return idx, vals, p0
    return idx, vals, None


def scatter_row(tag: str, it, vt, size: int, device, *,
                plain_reps: int = 3) -> dict:
    """The scatter's raw launch (both passes of one call in a CUDA graph,
    scratch allocated outside it), its wrapper, its plain version and
    ``zero_().index_add_`` timed on one stream; the bound counts the stream
    read once and the output written once."""
    import torch

    from repro_torch.kernels import build, ref, stream_decode

    n = it.numel()
    scatter = build.kernel("stream_scatter_add")
    out = torch.empty(size, device=device)
    work = stream_decode.workspace(n, size, device)

    def launch_scatter():
        build.check(scatter(it.data_ptr(), vt.data_ptr(), n, out.data_ptr(),
                            size, work.data_ptr(), work.numel(),
                            torch.cuda.current_stream().cuda_stream),
                    "stream_scatter_add")

    ms = graph_ms(launch_scatter)
    wrapper_ms = events_ms(lambda: stream_decode.stream_scatter_add_cuda(
        it, vt, size))
    plain_ms = events_ms(lambda: ref.stream_scatter_add_ref(it, vt, size),
                         reps=plain_reps, inner=plain_reps,
                         warmup=min(3, plain_reps))
    i64 = it.to(torch.int64)
    lib_out = torch.empty(size, device=device)
    lib_ms = graph_ms(lambda: lib_out.zero_().index_add_(0, i64, vt))
    bound_ms, bound_by = bound(8 * n + 4 * size, n)
    print(f"[kernels] stream_scatter_add {tag}: n={n} size={size} "
          f"ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
          f"plain_ms={plain_ms:.6f} zero+index_add_ms={lib_ms:.6f} "
          f"bound_ms={bound_ms:.6f} scratch_bytes={work.numel()}",
          flush=True)
    return dict(shape=tag, n=n, size=size, ms=ms, wrapper_ms=wrapper_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def scatter_check(tag: str, it, vt, size: int):
    """The kernel against its plain version on the card, on the same inputs:
    bit-equal (NaN lanes as NaN) and deterministic. Returns the kernel's
    output and the max abs error over the finite lanes."""
    import torch

    from repro_torch.kernels import ref, stream_decode

    out1 = stream_decode.stream_scatter_add_cuda(it, vt, size)
    out2 = stream_decode.stream_scatter_add_cuda(it, vt, size)
    torch.cuda.synchronize()
    plain = ref.stream_scatter_add_ref(it, vt, size)
    check(bits_equal_nan(out1, plain),
          f"stream_scatter_add != plain at {tag} (max abs "
          f"{max_err(out1, plain)})")
    check(bits_equal(out1, out2), f"stream_scatter_add not deterministic at "
          f"{tag}")
    return out1, max_err(out1, plain)


def kernel_phase(shapes, device) -> dict:
    import torch

    rows = {"stream_scatter_add": []}
    for tag, size, k, k_mask, C in shapes:
        n = C * (k + C * k_mask)
        # ---- scatter-add: adversarial correctness, then main-path timing
        idx, vals, p0 = scatter_inputs(n, size, seed=size % 9973,
                                       adversarial=True)
        out, err = scatter_check(tag, torch.from_numpy(idx).to(device),
                                 torch.from_numpy(vals).to(device), size)
        check(out[p0].item() == 0.0,
              f"order-sensitive triple folded out of order at {tag}")
        idx, vals, _ = scatter_inputs(n, size, seed=size % 9973 + 1,
                                      adversarial=False)
        it = torch.from_numpy(idx).to(device)
        vt = torch.from_numpy(vals).to(device)
        scatter_check(f"{tag} (clean stream)", it, vt, size)
        print(f"[kernels] stream_scatter_add {tag}: bit-equal=yes "
              f"deterministic=yes triple=0.0", flush=True)
        rows["stream_scatter_add"].append(dict(
            scatter_row(tag, it, vt, size, device), max_abs_err=err))

    return rows


def segmented_masks() -> bool:
    """Whether this tree's pair-mask kernel takes a segment table (the
    round launch); its parent launched once per leaf."""
    from repro_torch.kernels import build

    return build.SOURCES["pair_mask_streams.cu"]["pair_mask_streams"][0] \
        == "pair_mask_round_launch"


def raw_mask_launch(seeds32, signs, rows: int, peers: int, flags: int,
                    alive, segs):
    """The pair-mask kernel's C entry, called as the wrapper calls it:
    ``segs`` one ``(idx, vals, nb, k_mask, m, leaf_id or -1)`` each, the
    outputs preallocated. Returns a function that launches once."""
    import ctypes

    import torch

    from repro_torch.kernels import build

    fn = build.kernel("pair_mask_streams")
    desc = []
    for oi, ov, nb, k_mask, m, leaf in segs:
        desc += [oi.data_ptr(), ov.data_ptr(), nb, k_mask, m, leaf]
    arr = (ctypes.c_longlong * len(desc))(*desc)

    def launch():
        build.check(fn(seeds32.data_ptr(), signs.data_ptr(),
                       None if alive is None else alive.data_ptr(), peers,
                       rows, peers, flags, -1.0, 2.0, arr, len(segs),
                       torch.cuda.current_stream().cuda_stream),
                    "pair_mask_streams")

    return launch


def flat_mask_rows(shapes, device) -> list:
    """The flat per-pair call (one segment on a segmented tree) at the
    main path's leaf shapes: the 15 unordered pairs of a 5-client round."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, mask_prng, ref

    out = []
    for tag, size, _, k_mask, C in shapes:
        n_pairs = C * (C + 1) // 2
        rs = np.random.RandomState(size % 7919)
        seeds = rs.randint(0, 2**32, size=n_pairs, dtype=np.int64)
        seeds[0], seeds[1] = 2**32 - 1, 2**32 - 2     # wrap-around seeds
        st = torch.from_numpy(seeds).to(device)
        sg = torch.from_numpy(
            rs.choice([-1.0, 0.0, 1.0], size=n_pairs).astype(np.float32)
        ).to(device)
        ki, kv = mask_prng.pair_mask_streams_cuda(st, sg, nb=1,
                                                  k_mask=k_mask, m=size)
        torch.cuda.synchronize()
        pi, pv = ref.pair_mask_stream_ref(st, sg, 1, k_mask, size,
                                          p=-1.0, q=2.0)
        check(bits_equal(ki, pi) and bits_equal(kv, pv),
              f"pair_mask_streams != plain at {tag}")
        err = (kv - pv).abs().max().item()
        s32 = (st & 0xFFFFFFFF).to(torch.int32)
        oi = torch.empty((n_pairs, 1, k_mask), dtype=torch.int32,
                         device=device)
        ov = torch.empty((n_pairs, 1, k_mask), device=device)
        if segmented_masks():
            launch_masks = raw_mask_launch(s32, sg, n_pairs, 1, 0, None,
                                           [(oi, ov, 1, k_mask, size, -1)])
        else:                         # the parent's per-pair entry
            masks = build.kernel("pair_mask_streams")

            def launch_masks():
                build.check(masks(s32.data_ptr(), sg.data_ptr(), n_pairs,
                                  k_mask, size, -1.0, 2.0, oi.data_ptr(),
                                  ov.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream),
                            "pair_mask_streams")
        ms = graph_ms(launch_masks)
        wrapper_ms = events_ms(lambda: mask_prng.pair_mask_streams_cuda(
            st, sg, nb=1, k_mask=k_mask, m=size))
        plain_ms = events_ms(lambda: ref.pair_mask_stream_ref(
            st, sg, 1, k_mask, size, p=-1.0, q=2.0))
        elems = n_pairs * k_mask
        bound_ms, bound_by = bound(8 * n_pairs + 8 * elems,
                                   MASK_OPS_PER_SLOT * elems)
        out.append(dict(
            shape=f"flat {tag}", n=elems, size=size, ms=ms,
            wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
        print(f"[kernels] pair_mask_streams flat {tag}: pairs={n_pairs} "
              f"k_mask={k_mask} m={size} bit-equal=yes ms={ms:.6f} "
              f"wrapper_ms={wrapper_ms:.6f} plain_ms={plain_ms:.6f} "
              f"bound_ms={bound_ms:.6f}", flush=True)
    return out


def model_round(model: str, C: int = 5):
    """A round's mask inputs at a model's leaves: the protocol's seed and
    sign matrices for clients 0..C-1 (round 3), client 1 dropped and its
    seeds recovered, one ``(1, k_mask, size, leaf_id)`` per leaf under the
    table2 protocol (mask ratio 0.01)."""
    from repro_torch.core.types import SecureAggConfig
    from repro_torch.models.paper_models import build_model
    from repro_torch.secagg.protocol import RoundProtocol

    sa = SecureAggConfig(mask_ratio=0.01)
    sizes = [x.numel() for x in build_model(model, device="meta")
             .params().values()]
    proto = RoundProtocol.setup(sa, list(range(C)), 3)
    seeds, signs = proto.pair_seed_matrix()
    rec = proto.recover_seeds([c for c in range(C) if c != 1], [1])
    alive = [c != 1 for c in range(C)]
    leaves = [(1, sa.k_mask_for(n, C), n, leaf)
              for leaf, n in enumerate(sizes)]
    return seeds, signs, rec, alive, leaves


def mask_round_rows(device) -> list:
    """The round launch at mnist_mlp's 4 leaves and VGG16's 54: every
    leaf's masks, then every leaf's recovery streams, each in one launch,
    bit-equal to the segmented plain version and to the per-leaf flat
    launches; the raw launch (CUDA graph), the round function with its
    wrapper, the plain version and the bound. On a tree without the round
    launch (its parent) the round is its per-leaf flat launches, timed the
    same way."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import mask_prng, ref

    out = []
    for model in ("mnist_mlp", "cifar_vgg16"):
        seeds, signs, rec, alive, leaves = model_round(model)
        C = seeds.shape[0]
        slots = sum(C * C * nb * k for nb, k, _, _ in leaves)
        bound_ms, bound_by = bound(8 * slots + 8 * C * C,
                                   MASK_OPS_PER_SLOT * slots)
        tag = f"{model} round ({len(leaves)} leaves)"
        if not segmented_masks():
            sd, gd = seeds.to(device), signs.to(device, torch.float32)

            def per_leaf():
                return [se.mask_streams_all_pairs(sd, gd, nb, k, m, p=-1.0,
                                                  q=2.0, leaf_id=leaf)
                        for nb, k, m, leaf in leaves]
            iu, ju = torch.triu_indices(C, C).to(device)
            flat = []
            for nb, k, m, leaf in leaves:
                tri = se._fold_seeds(sd, leaf)[iu, ju]
                s32 = (tri & 0xFFFFFFFF).to(torch.int32)
                ones = torch.ones(len(tri), device=device)
                oi = torch.empty((len(tri), nb, k), dtype=torch.int32,
                                 device=device)
                flat.append((s32, ones, oi, torch.empty_like(oi,
                             dtype=torch.float32), nb * k, m))
            from repro_torch.kernels import build
            fn = build.kernel("pair_mask_streams")

            def launch():
                for s32, ones, oi, ov, L, m in flat:
                    build.check(fn(s32.data_ptr(), ones.data_ptr(), len(s32),
                                   L, m, -1.0, 2.0, oi.data_ptr(),
                                   ov.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream),
                                "pair_mask_streams")
            ms = graph_ms(launch)
            wrapper_ms = events_ms(per_leaf)
            out.append(dict(shape=tag, n=slots, ms=ms, wrapper_ms=wrapper_ms,
                            plain_ms=None, library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=0.0))
            print(f"[kernels] pair_mask_streams {tag}, per-leaf launches "
                  f"(parent): slots={slots} launches={len(leaves)} "
                  f"ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"bound_ms={bound_ms:.6f}", flush=True)
            continue
        sd, gd = se.round_matrices(device, seeds, signs)
        rd, ad = se.round_matrices(device, rec, alive)
        before = mask_prng.launches
        got = se.mask_streams_round(sd, gd, leaves, p=-1.0, q=2.0)
        rgot = se.recovery_streams_round(rd, gd, ad, leaves, p=-1.0, q=2.0)
        torch.cuda.synchronize()
        check(mask_prng.launches - before == 2,
              f"{tag}: {mask_prng.launches - before} launches for the masks "
              f"and the recovery streams, expected 2")
        plain = ref.pair_mask_segments_ref(sd, gd, leaves, mirror=True)
        rplain = ref.pair_mask_segments_ref(rd, gd, leaves, alive=ad)
        err = 0.0
        for (nb, k, m, leaf), (i, v), (pi, pv), r, (ri, rv) in zip(
                leaves, got, plain, rgot, rplain):
            fi, fv = se.mask_streams_all_pairs(sd, gd, nb, k, m, p=-1.0,
                                               q=2.0, leaf_id=leaf)
            fr = se.dropout_cancel_streams_seeded(rd, gd, ad, nb, k, m,
                                                  p=-1.0, q=2.0, leaf_id=leaf)
            check(bits_equal(i, pi) and bits_equal(v, pv)
                  and bits_equal(r.indices, ri) and bits_equal(r.values, rv),
                  f"{tag}: the round launch != plain at leaf {leaf}")
            check(bits_equal(i, fi) and bits_equal(v, fv)
                  and bits_equal(r.indices, fr.indices)
                  and bits_equal(r.values, fr.values),
                  f"{tag}: the round launch != the flat launches at leaf "
                  f"{leaf}")
            err = max(err, (v - pv).abs().max().item(),
                      (r.values - rv).abs().max().item())
        for kind, flags, sdev, alive_d, args in (
                ("masks", mask_prng.MIRROR, sd, None, dict(mirror=True)),
                ("recovery", mask_prng.GATE | mask_prng.GLOBAL
                 | mask_prng.PAIR_MAJOR, rd, ad,
                 dict(alive=ad))):
            outs = (got if kind == "masks" else
                    [(r.indices, r.values) for r in rgot])
            launch = raw_mask_launch(
                sdev, gd, C, C, flags, alive_d,
                [(i, v, nb, k, m, leaf) for (i, v), (nb, k, m, leaf)
                 in zip(outs, leaves)])
            ms = graph_ms(launch)
            if kind == "masks":
                wrapper_ms = events_ms(lambda: se.mask_streams_round(
                    sd, gd, leaves, p=-1.0, q=2.0))
            else:
                wrapper_ms = events_ms(lambda: se.recovery_streams_round(
                    rd, gd, ad, leaves, p=-1.0, q=2.0))
            plain_ms = events_ms(lambda: ref.pair_mask_segments_ref(
                sdev, gd, leaves, **args), reps=3, inner=3)
            out.append(dict(shape=f"{tag} {kind}", n=slots, ms=ms,
                            wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                            library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, max_abs_err=err))
            print(f"[kernels] pair_mask_streams {tag} {kind}: slots={slots} "
                  f"launches=1 bit-equal to plain and to {len(leaves)} flat "
                  f"launches=yes ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}",
                  flush=True)
    return out


def mask_path_probe(device) -> dict:
    """The mask path of one table2_quick round at mnist_mlp's 4 leaves (5
    clients), from the protocol's host matrices to the masks in the
    per-client layout with the top-1 override of inactive slots, as the
    encode runs it: the CUDA kernels and host-to-device copies
    (``torch.profiler``) and the time with the host (CUDA events). On the
    parent of the round launch: a copy, the masks and the override per
    leaf."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import streams as se

    seeds, signs, _, _, leaves = model_round("mnist_mlp")
    C = seeds.shape[0]
    gen = torch.Generator(device=device).manual_seed(0)
    accs = [torch.randn((C, 1, m), device=device, generator=gen)
            for _, _, m, _ in leaves]

    def override(m_idx, sg, acc, k_mask):
        top1 = torch.argmax(acc.abs(), -1).to(torch.int32)[..., None]
        active = torch.repeat_interleave(sg != 0.0, k_mask,
                                         dim=-1)[:, None, :]
        return torch.where(active, m_idx, top1)

    if hasattr(se, "mask_streams_round"):
        def call():
            sd, gd = se.round_matrices(device, seeds, signs)
            masks = se.mask_streams_round(sd, gd, leaves, p=-1.0, q=2.0)
            return [override(mi, gd, a, k) for (mi, _), a, (_, k, _, _)
                    in zip(masks, accs, leaves)]
    else:
        def call():
            out = []
            for a, (nb, k, m, leaf) in zip(accs, leaves):
                gd = signs.to(device, torch.float32)
                mi, _ = se.mask_streams_all_pairs(
                    seeds.to(device), gd, nb, k, m, p=-1.0, q=2.0,
                    leaf_id=leaf)
                out.append(override(mi, gd, a, k))
            return out

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_events = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
    kernels = [n for n in device_events
               if not n.startswith(("Memcpy", "Memset"))]
    h2d = [n for n in device_events if "HtoD" in n]
    mask_kernels = [n for n in kernels if "pair_mask" in n]
    ms = events_ms(call)
    out = {"kernels": len(kernels), "mask_kernels": len(mask_kernels),
           "h2d_copies": len(h2d), "ms": ms}
    print(f"[masks] one table2_quick round's mask path (mnist_mlp, "
          f"{len(leaves)} leaves, C={C}, top-1 override included): "
          f"{len(kernels)} CUDA kernels ({len(mask_kernels)} of the "
          f"pair-mask kernel), {len(h2d)} host-to-device copies, {ms:.6f} "
          f"ms with the host; kernels: {'; '.join(kernels)}", flush=True)
    return out


def scatter_tree_group_row(device) -> dict:
    """One tree group's buffer at tree_quick's ``l0.w``, built as
    ``core/streams.py::_scatter_range`` builds it: the round's stream with
    the slots outside the middle group's range sent to position ``width`` of
    a ``width + 1`` buffer with value +0.0 (about two thirds of the slots).
    Bit-equal to the plain version, deterministic, the dump slot +0.0; then
    timed as the other shapes."""
    import numpy as np
    import torch

    from repro_torch.core import schedules
    from repro_torch.core import streams as se
    from repro_torch.models.paper_models import build_model
    from repro_torch.sim import presets

    cfg = presets.get("tree_quick")
    model = build_model(cfg.model)
    names = model.leaf_names()
    sizes = [model.params()[n].numel() for n in names]
    i = names.index("l0.w")
    C, size = cfg.clients_per_round, sizes[i]
    k = schedules.leaf_ks(cfg.thgs, sizes, t=0, total_rounds=cfg.rounds)[i]
    n = C * (k + C * cfg.sa.k_mask_for(size, C))
    lo, hi = se.tree_splits(size, cfg.tree_groups)[1:3]
    width = hi - lo
    idx, vals, _ = scatter_inputs(n, size, seed=4242, adversarial=False)
    inside = (idx >= lo) & (idx < hi)
    idx = np.where(inside, idx - lo, width).astype(np.int32)
    vals = np.where(inside, vals, np.float32(0.0)).astype(np.float32)
    tag = f"tree_quick.l0.w.group1(width+1={width + 1})"
    it = torch.from_numpy(idx).to(device)
    vt = torch.from_numpy(vals).to(device)
    out, err = scatter_check(tag, it, vt, width + 1)
    check(out[width].view(torch.int32).item() == 0,
          f"the dump slot is not +0.0 at {tag}")
    print(f"[kernels] stream_scatter_add {tag}: slots={n} dumped="
          f"{int((~inside).sum())} bit-equal=yes deterministic=yes "
          f"dump slot=+0.0", flush=True)
    # the plain version folds the dump slot's multiplicity one pass at a
    # time (seconds a call): timed over one call
    return dict(scatter_row(tag, it, vt, width + 1, device, plain_reps=1),
                max_abs_err=err)


def scatter_cases(device) -> None:
    """Correctness-only inputs for the scatter, each against its plain
    version on the card: a stream all in one tile, one position reached by
    12,000 non-zero order-sensitive entries, an all-zero stream with -0.0
    slots and padding, +-inf and NaN among zeros, n = 0, size = 1, a size
    that is no multiple of any tile, n below one chunk, and an output of
    more than 8192 tiles (the fold accumulates in the output)."""
    import numpy as np
    import torch

    rs = np.random.RandomState(15)

    def rand(n, lo, hi):
        return (rs.randint(lo, hi, n).astype(np.int32),
                rs.randn(n).astype(np.float32))

    cases = [("one-tile", *rand(100_000, 0, 200), 156_800)]
    idx, vals = rand(60_000, 0, 50_000)
    hot = rs.choice(60_000, 12_000, replace=False)
    idx[hot] = 777
    vals[hot] = (rs.randn(12_000)
                 * np.exp2(rs.randint(-20, 20, 12_000))).astype(np.float32)
    cases.append(("hot-position", idx, vals, 50_000))
    idx = rs.randint(-3, 1000, 9000).astype(np.int32)
    vals = np.where(rs.rand(9000) < 0.5, 0.0, -0.0).astype(np.float32)
    cases.append(("all-zero", idx, vals, 997))
    idx, vals = rand(20_000, 0, 3000)
    sp = rs.choice(20_000, 300, replace=False)
    vals[sp] = rs.choice(np.array([np.inf, -np.inf, np.nan, 0.0, -0.0],
                                  np.float32), 300)
    cases.append(("inf-nan", idx, vals, 3000))
    cases.append(("n0", np.zeros(0, np.int32), np.zeros(0, np.float32), 100))
    cases.append(("size1", *rand(5000, -1, 2), 1))
    cases.append(("size1000003", *rand(300_000, -1, 1_000_004), 1_000_003))
    cases.append(("n100", *rand(100, -1, 700), 700))
    idx, vals = rand(20_000, 0, 300)
    cases.append(("size40M", idx * 100_003, vals, 40_000_000))
    for tag, idx, vals, size in cases:
        out, _ = scatter_check(tag, torch.from_numpy(idx).to(device),
                               torch.from_numpy(vals).to(device), size)
        check(tag != "all-zero" or not torch.signbit(out).any().item(),
              "an all-zero stream gave a -0.0")
    print(f"[kernels] stream_scatter_add correctness cases bit-equal to the "
          f"plain version (NaN lanes as NaN) and deterministic: "
          f"{', '.join(c[0] for c in cases)}", flush=True)


def pack_fields(rs, R: int, k: int, width: int, device):
    """uint32 fields below 2**width (int64 lanes) with 0 and the maximum in
    the first row."""
    import numpy as np
    import torch

    u = rs.randint(0, 2**32, (R, k), dtype=np.uint64) >> np.uint64(32 - width)
    u[0, :2] = [0, 2**width - 1]
    return torch.from_numpy(u.astype(np.int64)).to(device)


# the codec path's two-segment leaves: (tag, R, k, index width, value width)
PACK_LEAF_PAIRS = (("mnist_mlp.l0.w.int8", 5, 7880, 18, 8),
                   ("cifar_vgg16.512x512x3x3.1bit", 5, 60199, 22, 1))


def pack_pair_rows(rs, device) -> dict:
    """Each leaf pair packed and unpacked as ONE segmented launch, bit-equal
    to the plain versions with one launch counted a call; raw launch ms (a
    CUDA graph), wrapper ms and plain ms beside the bound of both segments.
    On a tree without the segmented launches (the parent, for a comparison
    in one call) the pair is two single-segment launches, as its codec path
    runs it."""
    import torch

    from repro_torch.kernels import build, ops, pack, ref

    segmented = hasattr(ops, "bitpack_segments")
    rows = {"bitpack_rows": [], "bitunpack_rows": []}
    for tag, R, k, wi, wv in PACK_LEAF_PAIRS:
        widths = [wi, wv]
        fields = [pack_fields(rs, R, k, w, device) for w in widths]
        plain_w = [ref.bitpack_rows_ref(u, w) for u, w in zip(fields, widths)]
        words_n = [ref.packed_words(k, w) for w in widths]
        f32 = [(u & ref.M32).to(torch.int32) for u in fields]
        w32 = [(x & ref.M32).to(torch.int32) for x in plain_w]
        if segmented:
            n0, m0 = pack.pack_launches, pack.unpack_launches
            words = ops.bitpack_segments(f32, widths=widths)
            back = ops.bitunpack_segments(words, ks=[k, k], widths=widths)
            torch.cuda.synchronize()
            check((pack.pack_launches - n0, pack.unpack_launches - m0)
                  == (1, 1), f"{tag}: a segmented call launched "
                  f"{pack.pack_launches - n0} / {pack.unpack_launches - m0} "
                  "times, expected 1 / 1")
            words = [x.to(torch.int64) & ref.M32 for x in words]
            back = [x.to(torch.int64) & ref.M32 for x in back]
        else:
            words = [pack.bitpack_rows_cuda(u, w)
                     for u, w in zip(fields, widths)]
            back = [pack.bitunpack_rows_cuda(x, k, w)
                    for x, w in zip(words, widths)]
            torch.cuda.synchronize()
        for x, y, u, pw, w in zip(words, back, fields, plain_w, widths):
            check(bits_equal(x, pw), f"bitpack {tag} w={w} != plain")
            check(bits_equal(y, ref.bitunpack_rows_ref(pw, k, w))
                  and bits_equal(y, u), f"bitunpack {tag} w={w} != plain "
                  "or no round trip")
        out_w = [torch.empty((R, W), dtype=torch.int32, device=device)
                 for W in words_n]
        out_u = [torch.empty((R, k), dtype=torch.int32, device=device)
                 for _ in widths]
        err = max(max((x - pw).abs().max().item() for x, pw in
                      zip(words, plain_w)),
                  max((y - u).abs().max().item() for y, u in
                      zip(back, fields)))

        def stream():                 # the capture stream inside a graph
            return torch.cuda.current_stream().cuda_stream

        if segmented:
            import ctypes

            def desc(srcs, outs, W_of):
                d = []
                for i, w in enumerate(widths):
                    d += [srcs[i].data_ptr(), outs[i].data_ptr(), R, k, w,
                          W_of[i]]
                return (ctypes.c_longlong * len(d))(*d)

            dp = desc(f32, out_w, words_n)
            du = desc(w32, out_u, words_n)
            fp = build.kernel("bitpack_segments")
            fu = build.kernel("bitunpack_segments")

            def launch_pack():
                build.check(fp(dp, 2, stream()), "bitpack_segments")

            def launch_unpack():
                build.check(fu(du, 2, stream()), "bitunpack_segments")

            def wrap_pack():
                ops.bitpack_segments(f32, widths=widths)

            def wrap_unpack():
                ops.bitunpack_segments(w32, ks=[k, k], widths=widths)
        else:
            fp = build.kernel("bitpack_rows")
            fu = build.kernel("bitunpack_rows")

            def launch_pack():
                for i, w in enumerate(widths):
                    build.check(fp(f32[i].data_ptr(), R, k, w,
                                   out_w[i].data_ptr(), words_n[i],
                                   stream()),
                                "bitpack_rows")

            def launch_unpack():
                for i, w in enumerate(widths):
                    build.check(fu(w32[i].data_ptr(), R, words_n[i], k, w,
                                   out_u[i].data_ptr(), stream()),
                                "bitunpack_rows")

            def wrap_pack():
                for u, w in zip(fields, widths):
                    pack.bitpack_rows_cuda(u, w)

            def wrap_unpack():
                for x, w in zip(plain_w, widths):
                    pack.bitunpack_rows_cuda(x, k, w)

        nbytes = sum(4 * R * k + 4 * R * W for W in words_n)
        launches_per_call = 1 if segmented else 2
        for name, launch, wrapper, plain_fn in (
                ("bitpack_rows", launch_pack, wrap_pack,
                 lambda: [ref.bitpack_rows_ref(u, w)
                          for u, w in zip(fields, widths)]),
                ("bitunpack_rows", launch_unpack, wrap_unpack,
                 lambda: [ref.bitunpack_rows_ref(x, k, w)
                          for x, w in zip(plain_w, widths)])):
            ms = graph_ms(launch)
            wrapper_ms = events_ms(wrapper)
            plain_ms = events_ms(plain_fn, reps=3, inner=3)
            bound_ms, bound_by = bound(nbytes, PACK_OPS_PER_FIELD * 2 * R * k)
            rows[name].append(dict(
                shape=tag, R=R, k=k, width=widths, words=words_n,
                segments=2, launches_per_call=launches_per_call, ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
            print(f"[kernels] {name} {tag} pair: R={R} k={k} w={widths} "
                  f"W={words_n} launches_per_call={launches_per_call} "
                  f"bit-equal=yes ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} "
                  f"library=none", flush=True)
    return rows


def pack_kernel_phase(device) -> dict:
    """The bit-pack kernels: every width 1..32, the four single-segment
    shapes and the two leaf pairs (first in the returned rows: the pairs
    are what the codec path launches)."""
    import numpy as np
    import torch

    from repro_torch.kernels import build, pack, ref

    rs = np.random.RandomState(12)
    for width in range(1, 33):
        u = pack_fields(rs, 3, 75, width, device)
        words = pack.bitpack_rows_cuda(u, width)
        back = pack.bitunpack_rows_cuda(words, 75, width)
        torch.cuda.synchronize()
        plain = ref.bitpack_rows_ref(u, width)
        check(bits_equal(words, plain), f"bitpack_rows != plain at w={width}")
        check(bits_equal(back, ref.bitunpack_rows_ref(plain, 75, width))
              and bits_equal(back, u),
              f"bitunpack_rows != plain or no round trip at w={width}")
    print("[kernels] bitpack_rows / bitunpack_rows: widths 1..32 at R=3 "
          "k=75 bit-equal=yes round-trip=yes", flush=True)
    rows = pack_pair_rows(rs, device)
    for tag, R, k, width in (("mnist_mlp.l0.w.index", 5, 7880, 18),
                             ("mnist_mlp.l0.w.int8", 5, 7880, 8),
                             ("cifar_vgg16.512x512x3x3.index", 5, 60199, 22),
                             ("cifar_vgg16.512x512x3x3.1bit", 5, 60199, 1)):
        W = ref.packed_words(k, width)
        u = pack_fields(rs, R, k, width, device)
        words = pack.bitpack_rows_cuda(u, width)
        back = pack.bitunpack_rows_cuda(words, k, width)
        torch.cuda.synchronize()
        plain_w = ref.bitpack_rows_ref(u, width)
        plain_u = ref.bitunpack_rows_ref(plain_w, k, width)
        check(bits_equal(words, plain_w), f"bitpack_rows != plain at {tag}")
        check(bits_equal(back, plain_u) and bits_equal(back, u),
              f"bitunpack_rows != plain or no round trip at {tag}")
        err_p = (words - plain_w).abs().max().item()
        err_u = (back - plain_u).abs().max().item()
        u32 = (u & ref.M32).to(torch.int32)
        w32 = (words & ref.M32).to(torch.int32)
        out_w = torch.empty((R, W), dtype=torch.int32, device=device)
        out_u = torch.empty((R, k), dtype=torch.int32, device=device)
        fpack = build.kernel("bitpack_rows")
        funpack = build.kernel("bitunpack_rows")

        def launch_pack():
            build.check(fpack(u32.data_ptr(), R, k, width, out_w.data_ptr(),
                              W, torch.cuda.current_stream().cuda_stream),
                        "bitpack_rows")

        def launch_unpack():
            build.check(funpack(w32.data_ptr(), R, W, k, width,
                                out_u.data_ptr(),
                                torch.cuda.current_stream().cuda_stream),
                        "bitunpack_rows")

        nbytes = 4 * R * k + 4 * R * W
        for name, launch, wrapper, plain_fn, err in (
                ("bitpack_rows", launch_pack,
                 lambda: pack.bitpack_rows_cuda(u, width),
                 lambda: ref.bitpack_rows_ref(u, width), err_p),
                ("bitunpack_rows", launch_unpack,
                 lambda: pack.bitunpack_rows_cuda(words, k, width),
                 lambda: ref.bitunpack_rows_ref(words, k, width), err_u)):
            ms = graph_ms(launch)
            wrapper_ms = events_ms(wrapper)
            plain_ms = events_ms(plain_fn, reps=3, inner=3)
            bound_ms, bound_by = bound(nbytes, PACK_OPS_PER_FIELD * R * k)
            rows[name].append(dict(
                shape=tag, R=R, k=k, width=width, words=W, ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err))
            print(f"[kernels] {name} {tag}: R={R} k={k} w={width} W={W} "
                  f"bit-equal=yes ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.8f} "
                  f"library=none", flush=True)
    return rows


# ----------------------------------------------- phase 2: thgs + mask apply
# (tag, elements): VGG16's largest leaf, the main path's l0.w, odd sizes
SPLIT_SIZES = (("cifar_vgg16.512x512x3x3", 2359296),
               ("mnist_mlp.l0.w", 156800), ("n1", 1), ("n97", 97), ("n255", 255), ("n257", 257),
               ("n50000", 50000))
DELTA = 0.1                 # not f32-exact: a tie at f32(0.1) is not kept
MASK_PQ = ((-1.0, 2.0), (-1.5, 3.0), (-0.7, 1.3))
# mix32 outputs whose uint32 -> f32 conversion rounds: around 2^24 and 2^25
# multiples (ties to even both ways), odd values near 2^32, and 0xFFFFFFFF,
# which rounds to 2^32 (u = p + q exactly)
U32_PROBES = (0, 2**24 - 1, 2**24 + 1, 2**24 + 3, 2**25 + 2, 2**25 + 6,
              2**31 + 1, 2**31 + 128, 2**31 + 384, 2**32 - 129, 2**32 - 128,
              2**32 - 127, 2**32 - 3, 2**32 - 1)


def unmix32(y: int) -> int:
    """Inverse of the murmur finalizer mix32 (a bijection on uint32)."""
    m = 2**32
    y ^= y >> 16
    y = y * pow(0x846CA68B, -1, m) % m
    y ^= (y >> 15) ^ (y >> 30)
    y = y * pow(0x7FEB352D, -1, m) % m
    return y ^ (y >> 16)


def bits_equal_nan(a, b) -> bool:
    """Bit-equal, except that a NaN matches any NaN (payloads differ between
    the x86 default NaN, torch's and CUDA's conversions)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ia = a.view(torch.int32 if a.dtype == torch.float32 else torch.int16)
    ib = b.view(ia.dtype)
    return torch.equal(ia[~na], ib[~nb])


def max_err(a, b) -> float:
    import torch

    d = (a.float() - b.float()).abs()
    d = d[torch.isfinite(d)]
    return d.max().item() if d.numel() else 0.0


def split_inputs(n: int, seed: int, g_dtype, r_dtype, device):
    """g ~ N(0, 1), r ~ N(0, 0.04), with planted ties at f32(DELTA) (when r
    is f32), +-inf accumulators and a -0.0 accumulator."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    g = rs.randn(n).astype(np.float32)
    r = (0.2 * rs.randn(n)).astype(np.float32)
    if n >= 8:
        d32 = np.float32(DELTA)
        g[:8] = [0.09375, -0.09375, np.inf, -np.inf, -0.0, d32, 2.0, -3.0]
        r[:8] = [d32 - np.float32(0.09375), np.float32(0.09375) - d32, 1.0,
                 -1.0, -0.0, 0.0, 0.5, 0.25]
    return (torch.from_numpy(g).to(device).to(g_dtype),
            torch.from_numpy(r).to(device).to(r_dtype))


def split_mask_kernel_phase(device) -> tuple[dict, dict]:
    """thgs_sparsify and mask_prng_apply: bit-equal to their plain versions
    (compared as bits) at VGG16's largest leaf, mnist_mlp's l0.w and odd
    sizes; then driven through ``ops`` over every leaf of both models with
    the counts reset before and read after; then timed."""
    import torch

    from repro_torch.core import schedules
    from repro_torch.core.types import THGSConfig
    from repro_torch.kernels import build, mask_prng, ops, ref
    from repro_torch.kernels import thgs_sparsify as thgs
    from repro_torch.models.paper_models import build_model

    f32, bf16 = torch.float32, torch.bfloat16
    errs = {"thgs_sparsify": 0.0, "mask_prng_apply": 0.0}
    # ---- correctness: every size, dtype pair and threshold kind
    for i, (tag, n) in enumerate(SPLIT_SIZES):
        pairs = ((f32, f32), (bf16, bf16)) if n > 10**6 else (
            (f32, f32), (bf16, bf16), (bf16, f32), (f32, bf16))
        for j, (gd, rd) in enumerate(pairs):
            g, r = split_inputs(n, 10 * i + j, gd, rd, device)
            thr = (torch.tensor(DELTA, dtype=f32, device=device) if j % 2 == 0
                   else DELTA)
            sk, rk = thgs.thgs_sparsify_cuda(g, r, thr)
            torch.cuda.synchronize()
            sp, rp = ref.thgs_sparsify_ref(g, r, DELTA)
            check(bits_equal_nan(sk, sp) and bits_equal_nan(rk, rp),
                  f"thgs_sparsify != plain at {tag} {gd}/{rd}")
            if n >= 8 and rd == f32:
                check(sk[0].item() == 0.0
                      and (gd != f32 or sk[5].item() == 0.0)
                      and sk[2].item() == float("inf")
                      and torch.isnan(rk[2:4].float()).all().item()
                      and rk[4].float().item() == 0.0
                      and torch.signbit(rk[4].float()).item(),
                      f"thgs_sparsify tie / inf / -0.0 cases wrong at {tag}")
            errs["thgs_sparsify"] = max(errs["thgs_sparsify"],
                                        max_err(sk, sp), max_err(rk, rp))
        gens = torch.Generator(device=device).manual_seed(500 + i)
        for gd in ((f32, bf16) if n >= 156800 else (f32,)):
            g = torch.randn(n, generator=gens, device=device).to(gd)
            for p, q in MASK_PQ:
                for sign in (1.0, -1.0):
                    for sigma in (p + 0.25 * q, 10.0):
                        ok, mk = mask_prng.mask_prng_apply_cuda(
                            g, 1234 + i, p=p, q=q, sigma=sigma, sign=sign)
                        torch.cuda.synchronize()
                        op, mp = ref.mask_prng_ref(g, 1234 + i, p=p, q=q,
                                                   sigma=sigma, sign=sign)
                        check(bits_equal(mk, mp) and bits_equal_nan(ok, op),
                              f"mask_prng_apply != plain at {tag} {gd} "
                              f"p={p} q={q} sign={sign} sigma={sigma}")
                        errs["mask_prng_apply"] = max(
                            errs["mask_prng_apply"], max_err(ok, op),
                            max_err(mk, mp))
        print(f"[kernels] thgs_sparsify / mask_prng_apply {tag}: n={n} "
              f"bit-equal=yes (dtype pairs, delta={DELTA} as a device "
              f"tensor and as a float, ties, +-inf, -0.0; p/q {MASK_PQ}, "
              f"both signs)", flush=True)
    g = torch.zeros(8, device=device)
    for pos, x in enumerate(U32_PROBES):
        seed = unmix32(x) ^ (pos % 8)
        for p, q in MASK_PQ:
            _, mk = mask_prng.mask_prng_apply_cuda(g, seed, p=p, q=q,
                                                   sigma=10.0, sign=-1.0)
            _, mp = ref.mask_prng_ref(g, seed, p=p, q=q, sigma=10.0,
                                      sign=-1.0)
            torch.cuda.synchronize()
            check(bits_equal(mk, mp), f"mask_prng_apply u32 probe {x:#x}")
            if x == 2**32 - 1:
                want = -torch.tensor(p, dtype=f32) - torch.tensor(q, dtype=f32)
                check(mk[pos % 8].item() == want.item(),
                      f"0xFFFFFFFF did not give u = p + q at p={p} q={q}")
    print(f"[kernels] mask_prng_apply uint32->f32 probes "
          f"{[hex(x) for x in U32_PROBES]}: bit-equal=yes, 0xFFFFFFFF gives "
          f"u = p + q", flush=True)

    # ---- the ops path: every leaf of mnist_mlp and VGG16 through the public
    # entries (no reference path calls these two kernels): the THGS split at
    # the round-0 top-k threshold, computed on the card, then a pair's two
    # masks, which cancel exactly
    thgs_cfg = THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    n_leaves = 0
    checks = []
    for model in ("mnist_mlp", "cifar_vgg16"):
        m = build_model(model)
        shapes = {n: tuple(t.shape) for n, t in m.params().items()}
        names = m.leaf_names()
        ks = schedules.leaf_ks(thgs_cfg, [m.params()[n].numel()
                                          for n in names], t=0,
                               total_rounds=12)
        gen = torch.Generator(device=device).manual_seed(7)
        for leaf_id, (name, k) in enumerate(zip(names, ks)):
            g = torch.randn(shapes[name], generator=gen, device=device)
            r = 0.1 * torch.randn(shapes[name], generator=gen, device=device)
            acc = (g + r).reshape(-1)
            delta = torch.topk(acc.abs(), min(k, acc.numel())).values[-1]
            sparse, resid = ops.thgs_sparsify(g, r, delta)
            seed = (0x5EED0000 + leaf_id) & 0xFFFFFFFF
            masked, mask = ops.mask_prng_apply(sparse, seed=seed, sigma=-0.98)
            _, peer = ops.mask_prng_apply(torch.zeros_like(sparse), seed=seed,
                                          sigma=-0.98, sign=-1.0)
            checks.append((name, g, r, delta, sparse, resid, seed, masked,
                           mask, peer))
            n_leaves += 1
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name, g, r, delta, sparse, resid, seed, masked, mask, peer in checks:
        sp, rp = ref.thgs_sparsify_ref(g, r, delta)
        mo, mp = ref.mask_prng_ref(sparse, seed, p=-1.0, q=2.0, sigma=-0.98)
        check(bits_equal(sparse, sp) and bits_equal(resid, rp)
              and bits_equal(masked, mo) and bits_equal(mask, mp),
              f"ops path differs from the plain versions at {name}")
        check(torch.equal(mask + peer, torch.zeros_like(mask)),
              f"a pair's masks do not cancel at {name}")
    del checks
    print(f"[kernels] ops path over {n_leaves} leaves of mnist_mlp and "
          f"cifar_vgg16 (top-k threshold on the card, a pair's two masks): "
          f"launches thgs_sparsify={counts['thgs_sparsify']} "
          f"mask_prng_apply={counts['mask_prng_apply']}, bit-equal to the "
          f"plain versions, masks cancel exactly", flush=True)
    check(counts["thgs_sparsify"] == n_leaves
          and counts["mask_prng_apply"] == 2 * n_leaves,
          f"ops path launches {counts} for {n_leaves} leaves")

    # ---- times at VGG16's largest leaf: raw launches in a CUDA graph over
    # enough buffer sets (> 150 MB) that every launch reads from HBM, not
    # from the 50 MB L2; the wrapper's whole call; the plain version
    rows = {"thgs_sparsify": [], "mask_prng_apply": []}
    n = SPLIT_SIZES[0][1]
    fsplit = build.kernel("thgs_sparsify")
    fmask = build.kernel("mask_prng_apply")
    for dt in (f32, bf16):
        code = build.DTYPE_CODES[dt]
        esz = torch.tensor([], dtype=dt).element_size()
        n_sets = max(2, -(-150_000_000 // (4 * esz * n)))
        sets = []
        for i in range(n_sets):
            g, r = split_inputs(n, 99 + i, dt, dt, device)
            sets.append((g, r, torch.empty_like(g), torch.empty_like(r),
                         torch.empty(n, dtype=f32, device=device)))
        thr = torch.tensor([DELTA], dtype=f32, device=device)
        turn = [0]

        def next_set():
            turn[0] += 1
            return sets[turn[0] % n_sets]

        def launch_split():
            g, r, so, ro, _ = next_set()
            build.check(fsplit(g.data_ptr(), r.data_ptr(), thr.data_ptr(),
                               0.0, n, code, code, so.data_ptr(),
                               ro.data_ptr(),
                               torch.cuda.current_stream().cuda_stream),
                        "thgs_sparsify")

        def launch_mask():
            g, _, so, _, mo = next_set()
            build.check(fmask(g.data_ptr(), n, 1234, -1.5, 3.0, -0.75, 1.0,
                              code, so.data_ptr(), mo.data_ptr(),
                              torch.cuda.current_stream().cuda_stream),
                        "mask_prng_apply")

        g, r = sets[0][:2]
        for name, launch, wrapper, plain, nbytes, nops in (
                ("thgs_sparsify", launch_split,
                 lambda: thgs.thgs_sparsify_cuda(g, r, thr),
                 lambda: ref.thgs_sparsify_ref(g, r, thr),
                 4 * esz * n + 4, 3 * n),
                ("mask_prng_apply", launch_mask,
                 lambda: mask_prng.mask_prng_apply_cuda(
                     g, 1234, p=-1.5, q=3.0, sigma=-0.75),
                 lambda: ref.mask_prng_ref(g, 1234, p=-1.5, q=3.0,
                                           sigma=-0.75),
                 (2 * esz + 4) * n, 24 * n)):
            ms = graph_ms(launch, inner=4 * n_sets)
            wrapper_ms = events_ms(wrapper)
            plain_ms = events_ms(plain, reps=3, inner=3)
            bound_ms, bound_by = bound(nbytes, nops)
            rows[name].append(dict(
                shape=f"{SPLIT_SIZES[0][0]}.{str(dt)[6:]}", n=n, ms=ms,
                wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs[name], bytes=nbytes))
            print(f"[kernels] {name} {SPLIT_SIZES[0][0]} {str(dt)[6:]}: "
                  f"n={n} graph_ms={ms:.6f} (cold: {n_sets} buffer sets) "
                  f"wrapper_ms={wrapper_ms:.6f} plain_ms={plain_ms:.6f} "
                  f"bound_ms={bound_ms:.6f} ({bound_by}: "
                  f"{nbytes / 1e6:.2f} MB, {nbytes / ms / 1e9:.3f} TB/s) "
                  f"library=none", flush=True)
        del sets
    return rows, counts


# ------------------------------------------------------------------ phase 4
def plain_unmasked_sum(info) -> "object":
    """The survivors' weighted sparse sum without masks, from the round's own
    encode inputs and stream indices, with the plain versions on the host."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import ref

    acc = (info["residuals"].float() + info["updates"].float()).cpu()
    C = acc.shape[0]
    acc = acc.reshape(C, -1)
    idx = info["streams"].indices.cpu().reshape(C, -1).to(torch.int64)
    first = se.first_occurrence_rows(idx)
    w = info["weights"].cpu()
    vals = w[:, None] * torch.gather(acc, 1, idx) * first.float()
    alive = info["alive"].cpu()
    return ref.stream_scatter_add_ref(idx[alive].reshape(-1),
                                      vals[alive].reshape(-1), acc.shape[1])


def clone_info(info) -> dict:
    import torch

    out = {}
    for key, v in info.items():
        if torch.is_tensor(v):
            v = v.clone()
        elif hasattr(v, "indices"):                       # a StreamBatch
            v = type(v)(v.indices.clone(), v.values.clone())
        out[key] = v
    return out


# ------------------------------------------------------------------ phase 6
def codec_phase(kind: str) -> dict:
    """codec_sweep_quick on the card; returns the sweep's launch counts."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    arms = presets.sweep_configs("codec_sweep_quick")
    results = {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for codec, cfg in arms.items():
        sim = Simulation(cfg.replace(out_json=None), device="cuda")
        probe = {}

        def first_leaf(leaf_id, name, info, probe=probe):
            if name == "l0.w" and not probe:
                probe.update(clone_info(info), leaf_id=leaf_id)

        sim.leaf_hook = first_leaf
        before = ops.launch_counts()
        res = sim.run()
        after = ops.launch_counts()
        check(all(torch.isfinite(p).all() for p in sim.state.params.values()),
              f"non-finite parameters in the {codec} arm")
        results[codec] = (res, {n: after[n] - before[n] for n in after},
                          probe)
    sweep_counts = ops.launch_counts()
    base = {a: results["f32"][0].ledger.totals(a)["upload_bits"]
            for a in ("paper", "tpu")}
    for codec, (res, counts, probe) in results.items():
        tp, tt = res.ledger.totals("paper"), res.ledger.totals("tpu")
        # round 0's l0.w, replayed on the CPU with the plain versions
        cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
               for k, v in probe.items()}
        size = cpu["size"]
        st, nr = se.encode_leaf_batch(
            cpu["updates"], cpu["residuals"], k=cpu["k"], nb=1, m=size,
            size=size, leaf_id=cpu["leaf_id"], weights=cpu["weights"],
            codec=codec)
        dense = se.decode_leaf_batch(st, nb=1, m=size, size=size)
        card_st = probe["streams"]
        idx_same = bits_equal(st.indices, card_st.indices.cpu())
        if codec == "1bit":
            cv, cn = card_st.values.cpu(), cpu["new_residuals"]
            gap = (cv.abs() - st.values.abs()).abs().max().item()
            same = (idx_same and torch.equal(cv.sign(), st.values.sign())
                    and gap <= ONE_BIT_REL * st.values.abs().max().item()
                    and (cn - nr).abs().max().item()
                    <= gap + nr.abs().max().item() * 2.0 ** -23)
            how = (f"indices bit-equal, values within 4 ulp "
                   f"(max |d|scale| {gap:.3e}): {same}")
        else:
            same = (idx_same and bits_equal(st.values, card_st.values.cpu())
                    and bits_equal(nr, cpu["new_residuals"])
                    and bits_equal(dense, cpu["dense"]))
            how = f"streams, residuals and decoded sum bit-equal: {same}"
        print(f"[codec] {codec:4s} on {kind}: rounds={res.rounds} upload "
              f"paper {tp['upload_mib']:.6f} MiB "
              f"({tp['upload_bits'] / base['paper']:.4%} of f32) tpu "
              f"{tt['upload_mib']:.6f} MiB "
              f"({tt['upload_bits'] / base['tpu']:.4%} of f32) "
              f"final_acc={res.final_acc:.4f} wall_s={res.wall_s:.4f} "
              f"launches={counts}", flush=True)
        print(f"[codec] {codec:4s} round 0 l0.w (k={cpu['k']}) replayed on "
              f"the CPU: {how}", flush=True)
        check(same, f"the card's round-0 l0.w {codec} encode differs from "
              "the CPU replay")
        n_leaves = len(res.ledger.entries[0].ks)
        # one segmented pack and one unpack launch a leaf: both streams
        want = 0 if codec == "f32" else n_leaves * res.rounds
        check(counts["bitpack_rows"] == want
              and counts["bitunpack_rows"] == want,
              f"{codec} arm launched the pack kernels {counts}, expected "
              f"{want} each")
        if codec != "f32":
            check(tp["upload_bits"] < base["paper"]
                  and tt["upload_bits"] < base["tpu"],
                  f"{codec} uploads no less than f32")
        check(res.final_acc >= 0.9, f"{codec} final_acc {res.final_acc:.4f}")
    check(tuple(results) == ("f32", "int8", "int4", "1bit"), "arms")
    check(results["int8"][0].ledger.totals("paper")["upload_bits"] * 3
          <= base["paper"], "int8 above a third of the f32 upload (paper)")
    print(f"[codec] codec_sweep_quick launches={sweep_counts}", flush=True)
    for name in ("bitpack_rows", "bitunpack_rows"):
        check(sweep_counts[name] == 144,
              f"{name} launched {sweep_counts[name]} times, expected 144")
    wire_roundtrip_probe(torch.device("cuda:0"))
    return sweep_counts


def wire_roundtrip_probe(device) -> dict:
    """One ``codec_wire_roundtrip`` call at mnist_mlp's ``l0.w`` under the
    int8 codec (5 clients, k = 7,880 of 156,800): the CUDA kernels it runs,
    counted on the card with ``torch.profiler`` (copies apart), and its time
    with the host's share (CUDA events). Runs on any tree of the port, so
    a parent and a change can be counted in one call."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import streams as se

    rs = np.random.RandomState(5)
    C, k, m = 5, 7880, 156800
    gidx = torch.from_numpy(np.stack([rs.choice(m, k, replace=False)
                                      for _ in range(C)])
                            .astype(np.int32)[:, None, :]).to(device)
    vals = torch.from_numpy(rs.randn(C, 1, k).astype(np.float32)).to(device)
    cols, q, scales, _ = se.codec_wire_stage(
        gidx, vals, torch.zeros((C, 1, m), device=device), None, m, "int8")

    def call():
        return se.codec_wire_roundtrip(cols, q, scales, m, "int8")

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    device_events = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
    kernels = [n for n in device_events
               if not n.startswith(("Memcpy", "Memset"))]
    runtime = sum(1 for e in prof.events()
                  if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    ms = events_ms(call)
    out = {"kernels": len(kernels), "copies": len(device_events)
           - len(kernels), "launch_calls": runtime, "ms": ms}
    print(f"[codec] one codec_wire_roundtrip (mnist_mlp l0.w, int8, C={C} "
          f"k={k}): {len(kernels)} CUDA kernels, {out['copies']} copies, "
          f"{runtime} launch calls, {ms:.6f} ms with the host; kernels: "
          f"{'; '.join(kernels)}", flush=True)
    return out


# ------------------------------------------------------------------ phase 7
def plain_noised_sum(info, leaf_id: int):
    """The survivors' unmasked noised sum of a DP round's leaf: gradient on
    the released slots (once per index), plus each client's noise, with the
    plain versions on the card."""
    import torch

    from repro_torch.core import dp, streams as se
    from repro_torch.kernels import ref

    C, size = info["updates"].shape[0], info["size"]
    k_data = min(info["k"], size)
    acc = (info["residuals"].float() + info["updates"].float()).reshape(C, -1)
    idx = info["streams"].indices.reshape(C, -1).to(torch.int64)
    first = se.first_occurrence_rows(idx)
    first[:, k_data:] = False
    vals = torch.where(first, torch.gather(acc, 1, idx), 0.0)
    noise = dp.add_stream_noise(
        torch.zeros((C, 1, idx.shape[1]), device=acc.device),
        info["dp_seeds"], sigma=info["dp_sigma"], leaf_id=leaf_id,
        k_data=k_data).reshape(C, -1)
    alive = info["alive"]
    return ref.stream_scatter_add_ref(idx[alive].reshape(-1),
                                      (vals + noise)[alive].reshape(-1), size)


def dp_phase(kind: str) -> None:
    import torch

    from repro_torch.core.dp import DPConfig
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get("dp_quick").replace(out_json=None)
    sim = Simulation(cfg, device="cuda")
    captured = {}

    def leaf_hook(leaf_id, name, info):
        if info["dropped"] and name == "l0.w" and "info" not in captured:
            captured.update(info=clone_info(info), leaf_id=leaf_id)

    sim.leaf_hook = leaf_hook
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    counts = ops.launch_counts()
    priv = res.ledger.privacy()
    check("info" in captured, "dp_quick dropped no client")
    want = plain_noised_sum(captured["info"], captured["leaf_id"])
    err = (captured["info"]["dense"] - want).abs().max().item()
    tol = 64 * 2.0 ** -24
    print(f"[dp] dp_quick on {kind}: eps={priv['epsilon']:.6f} at "
          f"delta={priv['delta']:g} over {priv['rounds']} rounds "
          f"final_acc={res.final_acc:.4f} launches={counts} dropout round "
          f"{captured['info']['dropped']}: decoded vs plain unmasked noised "
          f"sum max abs err {err:.3e} (tolerance 64 * 2^-24 = {tol:.3e})",
          flush=True)
    check(round(priv["epsilon"], 1) == 40.1,
          f"dp_quick eps {priv['epsilon']:.4f} != 40.1")
    check(err <= tol, f"DP dropout round off by {err:.3e}")
    for name in ("stream_scatter_add", "pair_mask_streams"):
        check(counts[name] > 0, f"dp_quick never launched {name}")
    dropout_rounds = sum(e.n_survivors < cfg.clients_per_round
                         for e in res.ledger.entries)
    check(counts["pair_mask_streams"] == cfg.rounds + dropout_rounds,
          f"dp_quick launched the masks {counts['pair_mask_streams']} times, "
          f"expected {cfg.rounds} + {dropout_rounds} (one a round, one more "
          f"a dropout round)")

    want_eps = {"z0.3": 89.7, "z0.6": 33.7, "z1.2": 14.1}
    arms = presets.dp_sweep_configs("dp_frontier_quick")
    off_sim = None
    for label, cfg in arms.items():
        sim = Simulation(cfg.replace(out_json=None), device="cuda")
        res = sim.run()
        priv = res.ledger.privacy()
        eps = priv["epsilon"] if priv else float("inf")
        up = res.ledger.totals("paper")
        print(f"[dp] dp_frontier_quick {label:4s}: eps={eps:.6f} "
              f"final_acc={res.final_acc:.4f} upload_vs_dense(paper)="
              f"{up['upload_vs_dense']:.6f}", flush=True)
        if label == "off":
            check(priv is None, "the off arm has a privacy block")
            off_sim, off_res = sim, res
        else:
            check(round(eps, 1) == want_eps[label],
                  f"{label} eps {eps:.4f} != {want_eps[label]}")
    inert = Simulation(arms["off"].replace(out_json=None, dp=DPConfig()),
                       device="cuda")
    inert_res = inert.run()
    same = (inert_res.ledger.summary() == off_res.ledger.summary()
            and all(bits_equal(inert.state.params[n], off_sim.state.params[n])
                    for n in off_sim.state.params))
    print(f"[dp] off arm vs the same run with an inactive DPConfig() "
          f"(clip=inf, sigma=0): parameters and ledger bit-identical={same}",
          flush=True)
    check(same, "an inactive DPConfig changed the off arm")


# --------------------------------------------------------- phase 8: tree
TREE_SURVIVORS = [5, 6, 4, 4, 4, 5, 5, 5]      # the reference's tree_quick
REF_ACC = {"tree_quick": 0.941, "async_quick": 0.938}
ACC_TOL = 0.02     # card vs the port's CPU run (f32 sums in another order)


def flat_of(info, sa) -> "object":
    """The flat decode of the streams a tree round decoded (same survivors,
    same recovery seeds), on the card."""
    from repro_torch.core import streams as se

    size = info["size"]
    dropped = bool(info.get("dropped"))
    return se.decode_leaf_batch(
        info["streams"], nb=1, m=size, size=size,
        alive=info["alive"] if dropped else None,
        pair_seeds=info["recovery_seeds"] if dropped else None,
        pair_signs=info["pair_signs"] if dropped else None,
        k_mask=info["k_mask"], mask_p=sa.p, mask_q=sa.q,
        leaf_id=info["leaf_id"])


def tree_phase(kind: str) -> dict:
    """tree_quick on the card (tree == flat on every leaf of every round),
    then 2 VGG16 rounds under the tree protocol."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get("tree_quick").replace(out_json=None)
    sim = Simulation(cfg, device="cuda")
    n_leaves = len(sim.model.leaf_names())
    kept = []

    def keep(leaf_id, name, info):
        kept.append(dict(clone_info(info), leaf_id=leaf_id))

    sim.leaf_hook = keep
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    counts = ops.launch_counts()
    same = all(bits_equal(k["dense"], flat_of(k, cfg.sa)) for k in kept)
    del kept
    cpu = Simulation(cfg, device="cpu").run()
    tp = res.ledger.totals("paper")
    surv = [e.n_survivors for e in res.ledger.entries]
    dropout_rounds = sum(s < cfg.clients_per_round for s in surv)
    print(f"[tree] tree_quick on {kind}: groups={cfg.tree_groups} "
          f"survivors={surv} launches={counts} upload_vs_dense(paper)="
          f"{tp['upload_vs_dense']:.6f} (total "
          f"{tp['total_upload_vs_dense']:.6f}, tpu "
          f"{res.ledger.totals('tpu')['upload_vs_dense']:.6f}) "
          f"final_acc={res.final_acc:.4f} (the port on the CPU "
          f"{cpu.final_acc:.4f}, the reference {REF_ACC['tree_quick']}) "
          f"accs={res.accuracies} wall_s={res.wall_s:.4f}", flush=True)
    print(f"[tree] every leaf of every round: tree decode bit-equal to the "
          f"flat decode of the same streams on the card={same} "
          f"({n_leaves} leaves x {cfg.rounds} rounds)", flush=True)
    check(same, "a tree decode differs from the flat decode")
    check(surv == TREE_SURVIVORS, f"survivors {surv} != {TREE_SURVIVORS}")
    check(abs(tp["upload_vs_dense"] - 0.063) <= 0.005,
          f"tree_quick upload {tp['upload_vs_dense']:.4f} outside 6.3% +- 0.5")
    check(abs(res.final_acc - cpu.final_acc) <= ACC_TOL,
          f"tree_quick accuracy {res.final_acc:.4f} vs the CPU's "
          f"{cpu.final_acc:.4f}")
    check(abs(res.final_acc - REF_ACC["tree_quick"]) <= ACC_TOL,
          f"tree_quick accuracy {res.final_acc:.4f} vs the reference's")
    check(counts["stream_scatter_add"] == 3 * n_leaves * cfg.rounds,
          f"tree_quick launched the scatter {counts['stream_scatter_add']} "
          f"times, expected 3 groups x {n_leaves} leaves x {cfg.rounds}")
    check(counts["pair_mask_streams"] == cfg.rounds + dropout_rounds,
          f"tree_quick launched the masks {counts['pair_mask_streams']} "
          f"times, expected {cfg.rounds} + {dropout_rounds} (one a round, "
          f"one more a dropout round)")

    # VGG16 under the tree protocol: full-size _scatter_range launches, and
    # the largest leaf also decoded over an uneven split
    cfg = vgg16_table2().replace(name="table2_vgg16_tree", topology="tree",
                                 tree_groups=3)
    sim = Simulation(cfg, device="cuda")
    checked, probe = [0, 0], {}

    def compare(leaf_id, name, info):
        before = ops.launch_counts()
        ok = bits_equal(info["dense"], flat_of(dict(info, leaf_id=leaf_id),
                                               cfg.sa))
        size = info["size"]
        if size == 2359296 and ok:
            uneven = (0, 1, 1_000_003, 1_999_999, size)
            ok = bits_equal(info["dense"], se.decode_leaf_tree(
                info["streams"], nb=1, m=size, size=size, splits=uneven,
                k_mask=info["k_mask"], leaf_id=leaf_id))
            checked[1] += 1
        after = ops.launch_counts()
        for k in after:
            probe[k] = probe.get(k, 0) + after[k] - before[k]
        check(ok, f"VGG16 tree decode differs from flat at {name}")
        checked[0] += 1

    sim.leaf_hook = compare
    ops.reset_launch_counts()
    res = sim.run()
    counts = {k: v - probe.get(k, 0) for k, v in ops.launch_counts().items()}
    finite = all(torch.isfinite(p).all() for p in sim.state.params.values())
    print(f"[tree] cifar_vgg16 table2 protocol, topology=tree groups=3: "
          f"rounds={cfg.rounds} launches={counts} (comparisons excluded) "
          f"leaves checked={checked[0]} (tree == flat, bit-equal; "
          f"{checked[1]} 2,359,296-element leaves also over the uneven "
          f"split (0, 1, 1000003, 1999999, 2359296)) wall_s="
          f"{res.wall_s:.4f} upload_vs_dense(paper)="
          f"{res.ledger.totals('paper')['upload_vs_dense']:.6f} "
          f"finite={finite}", flush=True)
    check(finite, "non-finite VGG16 parameters under the tree protocol")
    check(checked[1] > 0, "no 2,359,296-element leaf was checked")
    check(counts["stream_scatter_add"] == 3 * checked[0],
          f"VGG16 tree launched the scatter {counts['stream_scatter_add']} "
          f"times for {checked[0]} leaf decodes")
    return counts


# -------------------------------------------------------- phase 9: async
ASYNC_STALENESS = [[0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 3, 0],
                   [3, 3, 1, 2], [1, 0, 0, 2], [2, 0, 1, 1], [2, 3, 2, 3]]


def async_phase(kind: str) -> None:
    """async_quick on the card, then an all-fresh buffer against the
    synchronous round."""
    import torch

    from repro_torch.core import fedavg
    from repro_torch.core.types import SecureAggConfig
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import AsyncSimulation

    cfg = presets.get("async_quick").replace(out_json=None)
    sim = AsyncSimulation(cfg, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    counts = ops.launch_counts()
    cpu = AsyncSimulation(cfg, device="cpu").run()
    taus = [list(e.staleness) for e in res.ledger.entries]
    tp = res.ledger.totals("paper")
    print(f"[async] async_quick on {kind}: buffer={sim.buffer} "
          f"max_staleness={cfg.max_staleness} staleness={taus} "
          f"launches={counts} upload_vs_dense(paper)="
          f"{tp['upload_vs_dense']:.6f} (tpu "
          f"{res.ledger.totals('tpu')['upload_vs_dense']:.6f}) "
          f"final_acc={res.final_acc:.4f} (the port on the CPU "
          f"{cpu.final_acc:.4f}, the reference {REF_ACC['async_quick']}) "
          f"accs={res.accuracies} wall_s={res.wall_s:.4f}", flush=True)
    check(taus == ASYNC_STALENESS, f"staleness {taus}")
    check(abs(tp["upload_vs_dense"] - 0.070) <= 0.005,
          f"async_quick upload {tp['upload_vs_dense']:.4f} outside "
          "7.0% +- 0.5")
    check(abs(res.final_acc - cpu.final_acc) <= ACC_TOL,
          f"async_quick accuracy {res.final_acc:.4f} vs the CPU's "
          f"{cpu.final_acc:.4f}")
    check(abs(res.final_acc - REF_ACC["async_quick"]) <= 1.5 * ACC_TOL,
          f"async_quick accuracy {res.final_acc:.4f} vs the reference's")
    n_leaves = len(sim.model.leaf_names())
    check(counts["stream_scatter_add"] == n_leaves * cfg.rounds,
          f"async_quick launched the scatter {counts['stream_scatter_add']} "
          "times")

    # an all-fresh buffer (every tau 0) is the synchronous round, bit for bit
    state = sim._fresh_state()
    cohort = sim.sampler.cohort_for(0)
    batches = sim._batches_for(0, cohort)
    params = state.params
    a = fedavg.run_async_update(
        fedavg.init_state(params, sim.fed), batches,
        {c: params for c in batches}, sim.loss_fn, sim.fed, cfg.thgs)
    b = fedavg.run_round(fedavg.init_state(params, sim.fed), batches,
                         sim.loss_fn, sim.fed, cfg.thgs,
                         SecureAggConfig(enabled=False))
    same = (all(bits_equal(a.params[n], b.params[n]) for n in params)
            and all(bits_equal(a.residuals[c][n], b.residuals[c][n])
                    for c in batches for n in params)
            and a.losses == b.losses)
    print(f"[async] all-fresh buffer {sorted(batches)} through "
          f"run_async_update vs run_round on {kind}: parameters, residuals "
          f"and losses bit-equal={same}", flush=True)
    check(same, "an all-fresh async buffer differs from the sync round")


# ------------------------------------------------------------------ phase 8
# (tag, B, T, S, Hq, Hkv, hd, dtype, causal, window, needle). The first two
# are timed beside the bound, the plain version and SDPA; so is every f32 row
# of T = S without a window or needle (the 3xTF32 instance), beside both of
# its bounds and SDPA in f32 under each backend in turn. A needle is a key of
# V set to 1000.0
# that the rows it names must not see: an int is a key position (the rows
# before it under causal, the rows past its window), "pad" fills the memory
# past S of a B = 1 view with it (no row may read past S). A mask or
# descriptor fault then errs by hundreds.
FLASH_SHAPES = (
    ("yi_6b.prefill", 4, 1024, 1024, 32, 4, 128, "bfloat16", True, None,
     None),
    ("yi_6b.long", 1, 4096, 4096, 32, 4, 128, "bfloat16", True, None, None),
    ("f32", 2, 256, 256, 8, 2, 64, "float32", True, None, None),
    ("tail24", 2, 24, 24, 32, 4, 128, "bfloat16", True, None, None),
    ("tail1000", 1, 1000, 1000, 8, 2, 64, "float32", True, None, None),
    ("mqa", 2, 512, 512, 32, 1, 128, "bfloat16", True, None, None),
    ("window256", 1, 1000, 1000, 32, 4, 128, "bfloat16", True, 256, None),
    ("hd64", 2, 512, 512, 8, 2, 64, "bfloat16", True, None, None),
    ("noncausal", 2, 384, 384, 8, 2, 128, "bfloat16", False, None, None),
    ("t_gt_s", 1, 100, 40, 4, 2, 64, "bfloat16", True, 8, None),
    ("ragged", 2, 333, 333, 8, 2, 128, "bfloat16", True, None, None),
    ("ragged.t_ne_s", 1, 700, 333, 8, 2, 128, "bfloat16", False, None,
     None),
    ("window256.hd64", 1, 700, 700, 8, 2, 64, "bfloat16", False, 256, None),
    ("needle.causal", 1, 256, 256, 8, 2, 128, "bfloat16", True, None, 200),
    ("needle.window", 1, 1000, 1000, 8, 2, 128, "bfloat16", True, 256, 300),
    ("needle.pad", 1, 300, 300, 8, 2, 64, "bfloat16", False, None, "pad"),
    # the families' other prefill shapes (phase 16): Llama-3.2-Vision's
    # cross-attention over 1,024 image tokens and its self layers,
    # DeepSeek-MoE's and Llama-4-Scout's self layers
    ("vlm.cross", 2, 1024, 1024, 64, 8, 128, "bfloat16", False, None, None),
    ("vlm.self", 2, 1024, 1024, 64, 8, 128, "bfloat16", True, None, None),
    ("deepseek.self", 4, 1024, 1024, 16, 16, 128, "bfloat16", True, None,
     None),
    ("llama4.self", 4, 1024, 1024, 40, 8, 128, "bfloat16", True, None, None),
    # head widths 80 (HuBERT-XLarge, 1280 / 16) and 112 (Zamba2-7B's shared
    # block, 3584 / 32): P V on the tensor cores at the width padded to 128
    ("hubert.encode", 4, 1024, 1024, 16, 16, 80, "bfloat16", False, None,
     None),
    ("zamba2.shared", 4, 1024, 1024, 32, 32, 112, "bfloat16", True, None,
     None),
    ("f32.hd80", 2, 256, 256, 8, 8, 80, "float32", False, None, None),
    ("f32.hd112", 2, 256, 256, 8, 8, 112, "float32", True, None, None),
    ("tail24.hd80", 2, 24, 24, 16, 16, 80, "bfloat16", False, None, None),
    ("ragged.hd112", 1, 333, 333, 32, 32, 112, "bfloat16", True, None, None),
    ("tail1000.hd80.f32", 1, 1000, 1000, 4, 4, 80, "float32", False, None,
     None),
    ("tail1000.hd112.f32", 1, 1000, 1000, 4, 4, 112, "float32", True, None,
     None),
    ("needle.causal.hd112", 1, 256, 256, 8, 8, 112, "bfloat16", True, None,
     200),
    ("needle.window.hd80", 1, 1000, 1000, 8, 8, 80, "bfloat16", True, 256,
     300),
    ("needle.pad.hd80", 1, 300, 300, 8, 8, 80, "bfloat16", False, None,
     "pad"),
    ("needle.pad.hd112", 1, 300, 300, 8, 8, 112, "bfloat16", True, None,
     "pad"),
    # Yi-6B in f32: [lm]'s card-vs-CPU parity prompt (B 1, 256 tokens) and
    # its full prefill shape
    ("yi_6b.parity.f32", 1, 256, 256, 32, 4, 128, "float32", True, None,
     None),
    ("yi_6b.prefill.f32", 4, 1024, 1024, 32, 4, 128, "float32", True, None,
     None),
    # the f32 instance's edges, checked and not timed: T > S with keyless
    # rows, T != S off the tile grid, a window, and the needles
    ("t_gt_s.f32", 1, 100, 40, 4, 2, 64, "float32", True, 8, None),
    ("ragged.t_ne_s.f32", 1, 700, 333, 8, 2, 128, "float32", False, None,
     None),
    ("needle.window.f32", 1, 1000, 1000, 8, 2, 128, "float32", True, 256,
     300),
    ("needle.causal.hd112.f32", 1, 256, 256, 8, 8, 112, "float32", True,
     None, 200),
    ("needle.pad.hd80.f32", 1, 300, 300, 8, 8, 80, "float32", False, None,
     "pad"),
)
# bf16 rows timed beside the bound, the plain version and SDPA (every f32
# row is too): the first is the kernel's main row in the report
FLASH_TIMED = ("yi_6b.prefill", "yi_6b.long", "hubert.encode",
               "zamba2.shared")
SDPA_BACKENDS = ("MATH", "EFFICIENT_ATTENTION", "FLASH_ATTENTION",
                 "CUDNN_ATTENTION")
NEEDLE = 1000.0


def visible_pairs(T: int, S: int, causal: bool, window) -> int:
    """The (query, key) pairs the mask keeps: the score and P V work."""
    n = 0
    for q in range(T):
        hi = min(q, S - 1) if causal else S - 1
        lo = max(0, q - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


def flash_inputs(B, T, S, H, Hkv, hd, dtype, causal, window, needle,
                 seed: int, device):
    """q, k, v from a seed, with the needle placed; and the rows that must
    not see it (None: no needle)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    pad = 128 if needle == "pad" else 0
    q = torch.randn((B, T, H, hd), generator=gen, device=device).to(dtype)
    k, v = (torch.randn((B, S + pad, Hkv, hd), generator=gen,
                        device=device).to(dtype) for _ in range(2))
    if needle is None:
        return q, k, v, None
    if needle == "pad":
        k[:, S:] = 30.0              # large scores, were the pad ever read
        v[:, S:] = NEEDLE
        k, v = k[:, :S], v[:, :S]    # B = 1: a prefix, so no copy is made
        return q, k, v, torch.ones(T, dtype=torch.bool, device=device)
    v[:, needle] = NEEDLE
    pos = torch.arange(T, device=device)
    blind = torch.zeros(T, dtype=torch.bool, device=device)
    if causal:
        blind |= needle > pos
    if window is not None:
        blind |= needle <= pos - window
    return q, k, v, blind


def flash_mma_counts(lib) -> tuple[int, dict]:
    """The bf16 instances' HGMMA and each f32 instance's TF32 tensor-core
    instructions (HGMMA or HMMA with TF32) in the built library's SASS
    (``cuobjdump -sass``)."""
    from repro_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    check(cuobjdump.exists(), f"no cuobjdump beside nvcc ({cuobjdump})")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120).stdout
    bf16, tf32, fn = 0, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"f32_kernelILi(\d+)ELi(\d+)E", line)
            fn = f"hd{m.group(1)}.nw{m.group(2)}" if m else None
            if fn:
                tf32[fn] = 0
        elif fn is None and "HGMMA" in line:
            bf16 += 1
        elif fn and "MMA" in line and "TF32" in line:
            tf32[fn] += 1
    return bf16, tf32


def sdpa_rows(q, k, v, causal: bool, plain) -> tuple[float, str]:
    """``scaled_dot_product_attention`` on q, k, v ``[B,T,H,hd]`` as the
    library yardstick: its default call timed (ms), then each backend pinned
    in turn (time, error against the plain version, or refused); the default
    took the backend whose output has its bits."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    default = call()
    default_ms = events_ms(call, reps=5, inner=10)
    took, parts = "none of them", []
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                out = call()
                ms = events_ms(call, reps=5, inner=10)
        except RuntimeError:
            parts.append(f"{name} refused")
            continue
        err = (out.transpose(1, 2).float() - plain.float()).abs().max().item()
        parts.append(f"{name} {ms:.6f} ms err {err:.3e}")
        if took == "none of them" and bits_equal(out, default):
            took = name
        del out
    return default_ms, (f"sdpa_ms={default_ms:.6f} (took {took}; "
                        + "; ".join(parts) + ")")


def flash_phase(device, require_mma: bool = True) -> list:
    import torch

    from repro_torch.kernels import build, flash_attention as flash, ref

    # both instances run on the tensor cores: HGMMA in the bf16 ones, TF32
    # HGMMA in every f32 one (three passes a product)
    lib = build._lib_path("flash_attention.cu")
    hgmma, tf32 = flash_mma_counts(lib)
    print(f"[flash] {lib.name}: {hgmma} HGMMA in the bf16 instances, "
          f"{sum(tf32.values())} TF32 MMA in {len(tf32)} f32 instances "
          f"({', '.join(f'{n} {c}' for n, c in tf32.items())}) in its SASS "
          "(cuobjdump -sass)", flush=True)
    check(hgmma > 0 or not require_mma,
          "the flash library has no HGMMA instruction")
    check((tf32 and min(tf32.values()) > 0) or not require_mma,
          "an f32 flash instance has no TF32 tensor-core instruction")

    rows = []
    for i, (tag, B, T, S, H, Hkv, hd, dt, causal, window, needle) in (
            enumerate(FLASH_SHAPES)):
        dtype = getattr(torch, dt)
        q, k, v, blind = flash_inputs(B, T, S, H, Hkv, hd, dtype, causal,
                                      window, needle, 100 + i, device)
        out = flash.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        diff = (out.float() - plain.float()).abs()
        err = diff.max().item()
        rel = err / plain.float().abs().max().item()
        check(out.dtype == dtype and out.shape == q.shape
              and torch.allclose(out.float(), plain.float(), rtol=tol,
                                 atol=tol),
              f"flash_attention != plain at {tag} (max abs {err:.3e}, "
              f"tolerance {tol})")
        row = dict(shape=tag, B=B, T=T, S=S, H=H, Hkv=Hkv, hd=hd, dtype=dt,
                   causal=causal, window=window, max_abs_err=err,
                   rel_err=rel)
        line = (f"[flash] {tag}: B={B} T={T} S={S} H={H} Hkv={Hkv} hd={hd} "
                f"{dt} causal={causal} window={window} max_abs_err={err:.3e} "
                f"rel_err={rel:.3e} (tolerance {tol})")
        if blind is not None:
            n_blind = int(blind.sum())
            check(n_blind > 0, f"{tag}: no row is blind to the needle")
            blind_err = diff[:, blind].max().item()
            blind_max = plain.float()[:, blind].abs().max().item()
            row.update(needle=needle, blind_rows=n_blind,
                       blind_max_abs_err=blind_err)
            line += (f" needle={needle}: {n_blind} rows blind to it, their "
                     f"max_abs_err={blind_err:.3e} (max |plain| "
                     f"{blind_max:.3f})")
            check(blind_err <= tol * (1 + blind_max),
                  f"{tag}: rows blind to the needle err by {blind_err:.3e}")
        f32 = dtype == torch.float32
        if tag in FLASH_TIMED or (f32 and T == S and window is None
                                  and needle is None):
            check(window is None and T == S, f"{tag}: SDPA takes no window")
            fn = build.kernel("flash_attention")
            o = torch.empty_like(q)

            def launch():
                build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), B, T, S, H, Hkv, hd, int(causal),
                               window or 0, build.DTYPE_CODES[dtype],
                               torch.cuda.current_stream().cuda_stream),
                            "flash_attention")

            ms = graph_ms(launch, reps=5, inner=10)
            # 4 hd flops (two products) for each pair the mask keeps, at the
            # true head width; f32 at a third of the TF32 rate (three passes),
            # and, to compare with the CUDA-core rows before it, at the f32
            # rate of the CUDA cores
            flops = 4 * B * H * hd * visible_pairs(T, S, causal, window)
            nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
            rate = TF32_FLOPS / 3 if f32 else BF16_FLOPS
            bound_ms, bound_by = bound(nbytes, flops, rate)
            row.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                       flops=flops, bytes=nbytes)
            line += (f" ms={ms:.6f} bound_ms={bound_ms:.6f} ({bound_by}"
                     f"{' at 3xTF32' if f32 else ''}: {flops:.4g} flops, "
                     f"{nbytes / 1e6:.1f} MB)")
            if f32:
                row["bound_cuda_cores_ms"] = bound(nbytes, flops)[0]
                line += (f" bound_cuda_cores_ms="
                         f"{row['bound_cuda_cores_ms']:.6f}")
            line += f" TFLOP/s={flops / ms / 1e9:.2f}"
            plain_ms = events_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal), reps=3, inner=2)
            lib_ms, lib_line = sdpa_rows(q, k, v, causal, plain)
            row.update(plain_ms=plain_ms, library_ms=lib_ms)
            line += (f" plain_ms={plain_ms:.6f} {lib_line} vs_bound="
                     f"{ms / bound_ms:.2f}x vs_sdpa={ms / lib_ms:.2f}x")
        rows.append(row)
        print(line, flush=True)
        del q, k, v, out, plain
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------------ phase 9
LM_TOL = 2e-4      # f32 logits, card vs CPU: sum order over d_model 4096


def lm_phase(kind: str, card: str, flash_main_ms: float) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, serving
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_generate
    from repro_torch.models import transformer as tf

    cfg = configs.get("yi_6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} {cfg.dtype}: {n_params} parameters "
          f"({n_params * 2 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(n_params == 6_061_035_520, f"Yi-6B has {n_params} parameters")
    B, T, n_new = 4, 1024, 16
    prompts, _ = make_lm_tokens(cfg.vocab, 8, T, seed=1)
    prompts = np.asarray(prompts, np.int32)
    adapter = serving.LMAdapter(cfg, max_batch=B, prompt_len=T, n_new=n_new)
    # warm-up batch (cuBLAS handles, allocator) outside the counted run
    warm = serving.InferenceServer(adapter, params)
    ticket = warm.submit(prompts[0])
    warm.step()
    ticket.wait(0)

    metrics = serving.ServingMetrics(offered_qps=100.0)
    server = serving.InferenceServer(adapter, params, metrics=metrics)
    loadgen = serving.LoadGenerator(server, prompts, 100.0, metrics=metrics,
                                    wait_timeout_s=300.0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    server.start()
    try:
        loadgen.run(n_requests=len(prompts))
        tickets = list(loadgen._tickets)
        errors = loadgen.drain()
    finally:
        server.stop()
    counts = ops.launch_counts()
    doc = metrics.summary()
    outs = [t.wait(0) for t in tickets]
    prefills = doc["batches"]["count"]
    lat = doc["latency_us"]
    print(f"[lm] served {doc['requests']} in {prefills} batches (fills "
          f"{metrics.batch_fills}) launches={counts} tokens="
          f"{doc['tokens']['generated']} tok_s={doc['tokens']['tok_s']:.2f} "
          f"wall_s={doc['wall_s']:.4f} latency p50={lat['p50'] / 1e3:.1f} ms "
          f"p99={lat['p99'] / 1e3:.1f} ms", flush=True)
    print(f"[lm] first response: {list(map(int, outs[0]))}", flush=True)
    check(errors == 0 and doc["requests"] == {"submitted": 8, "served": 8,
                                              "errors": 0},
          f"served {doc['requests']} with {errors} errors")
    check(all(o.shape == (n_new,) and o.dtype == np.int32
              and int(o.min()) >= 0 and int(o.max()) < cfg.vocab
              for o in outs), "a response is not 16 tokens in the vocabulary")
    check(counts["flash_attention"] == cfg.n_layers * prefills,
          f"flash_attention launched {counts['flash_attention']} times for "
          f"{prefills} prefills of {cfg.n_layers} layers")
    errs = serving.validate_metrics(doc)
    check(not errs, f"invalid repro.serve/v1 document: {errs}")

    # prefill and decode times at the served shape, synchronous
    tokens = torch.from_numpy(prompts[:B]).cuda()
    cache_len = adapter.cache_len
    times = {"prefill": [], "decode": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = tf.prefill(params, cfg, tokens, cache_len)
        torch.cuda.synchronize()
        times["prefill"].append(time.perf_counter() - t0)
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        t0 = time.perf_counter()
        for _ in range(n_new - 1):
            logits, state = tf.decode_step(params, cfg, tok, state)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        times["decode"].append((time.perf_counter() - t0) / (n_new - 1))
    prefill_ms = statistics.median(times["prefill"]) * 1e3
    decode_ms = statistics.median(times["decode"]) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    share = cfg.n_layers * flash_main_ms / prefill_ms
    print(f"[lm] {card}: prefill B={B} T={T} {prefill_ms:.3f} ms "
          f"({B * T / prefill_ms * 1e3:.0f} tok/s), decode "
          f"{decode_ms:.3f} ms a token step at B={B} "
          f"({B / decode_ms * 1e3:.1f} tok/s), served "
          f"{doc['tokens']['tok_s']:.2f} tok/s, peak memory "
          f"{peak_gib:.2f} GiB, flash kernel {cfg.n_layers} x "
          f"{flash_main_ms:.4f} ms = {share:.1%} of a prefill", flush=True)
    # where a prefill's and a decode step's time goes: kernel launches and
    # device time (one stream: kernels do not overlap) against the wall
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for what, fn in (
            ("prefill", lambda: tf.prefill(params, cfg, tokens, cache_len)),
            ("decode step", lambda: tf.decode_step(params, cfg, tok, state))):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
               for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))]
        dev = [d for d in dev if d[2] > 0]
        dev_ms = sum(d[2] for d in dev) / 1e3
        flash_ms = sum(d[2] for d in dev if "flash_attention" in d[0]) / 1e3
        top = sorted(dev, key=lambda d: -d[2])[:4]
        print(f"[lm] profiled {what}: wall {wall_ms:.3f} ms, "
              f"{sum(d[1] for d in dev)} kernel launches, device "
              f"{dev_ms:.3f} ms (busy {dev_ms / wall_ms:.1%}), flash "
              f"{flash_ms:.3f} ms; top: " + "; ".join(
                  f"{k[:48]} x{c} {t / 1e3:.3f} ms" for k, c, t in top),
              flush=True)
    del state, logits
    torch.cuda.empty_cache()
    counts = {**counts, "flash_attention": counts["flash_attention"]
              + serve_grid_yi6b(card, params)}
    serve_long_yi6b(card, params)
    del params
    torch.cuda.empty_cache()
    counts["flash_attention"] += serve_long_layers(card)

    # parity at full width, reduced depth: the card against the CPU
    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_model = tf.init_params(small,
                                torch.Generator(device="cuda").manual_seed(0))
    cpu_model = tf.init_params(small, device="cpu")
    cpu_model.load_state_dict(card_model.state_dict())
    prompt, _ = make_lm_tokens(cfg.vocab, 1, 256, seed=2)
    prompt = torch.from_numpy(np.asarray(prompt, np.int32))
    ops.reset_launch_counts()
    lc, _ = tf.prefill(card_model, small, prompt.cuda(), 264)
    check(ops.launch_counts()["flash_attention"] == 2,
          "the parity prefill did not run the flash kernel")
    lp, _ = tf.prefill(cpu_model, small, prompt, 264)
    err = (lc.cpu() - lp).abs().max().item()
    gc = greedy_generate(card_model, small, prompt.cuda(), 4, 264).cpu()
    gp = greedy_generate(cpu_model, small, prompt, 4, 264)
    print(f"[lm] parity {cfg.name} full width, 2 layers, f32 (TF32 off), "
          f"prompt 256: prefill logits card vs CPU max abs err {err:.3e} "
          f"(max |logit| {lp.abs().max().item():.3f}, tolerance {LM_TOL}); "
          f"greedy tokens card {gc.tolist()} CPU {gp.tolist()}", flush=True)
    check(err <= LM_TOL, f"card vs CPU logits differ by {err:.3e}")
    check(torch.equal(gc, gp), "card and CPU greedy tokens differ")
    del card_model, cpu_model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------- phase 16: families
# (arch, layers on the card or None for all, batch): full width, random
# bf16 weights drawn on the card from seed 0, one config at a time. xLSTM
# runs 4 of its 12 layers (two sLSTM, two mLSTM): its sLSTM steps one token
# a host call, and all 12 took ~42 s of [families] and ~13 s of [train]
FAMILY_CELLS = (("deepseek_moe_16b", 8, 4), ("llama4_scout_17b_a16e", 2, 4),
                ("llama32_vision_90b", 10, 2), ("zamba2_7b", None, 4),
                ("xlstm_125m", 4, 4), ("hubert_xlarge", None, 4))
FAMILY_T = 1024          # prompt tokens (audio: frames; VLM: image tokens)
FAMILY_NEW = 16          # greedy tokens
# the reference's contract (tests/test_models_smoke.py): forward over T + 1
# tokens against prefill(T) + one decode step, last-position logits, in
# bf16: |diff| <= 2^-4 * max(1, max |logit|) (a few bf16 ulps of a logit:
# the two paths round their products and the residual stream to bf16 at
# different shapes, and the decode's attention keeps bf16 scores)
FAMILY_TOL = 2.0 ** -4
MOE_F32_RTOL, MOE_F32_ATOL = 2e-2, 2e-3   # the reference test's allclose
# one MoE layer in f32 at the configured capacity, card vs CPU: the largest
# |y| gap (sum order of the expert and shared products), 4x the larger
# reading (9.775e-06 DeepSeek-MoE, 1.347e-05 Llama-4-Scout; max |y| 3.4-3.8)
MOE_CAP_ATOL = 5.4e-5


def profiled(fn, top: int = 3, name_len: int = 48) -> dict:
    """Wall ms, CUDA kernel launches and device ms of one call of fn
    (``torch.profiler``, device activity only: the host's op events would
    cost a long trace on a prefill of 100,000+ launches; one stream, so
    kernels do not overlap); the ``top`` kernels by device time, names cut
    to ``name_len``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
           for e in prof.key_averages()
           if "CUDA" in str(getattr(e, "device_type", ""))]
    dev = [d for d in dev if d[2] > 0]
    dev_ms = sum(d[2] for d in dev) / 1e3
    top = sorted(dev, key=lambda d: -d[2])[:top]
    return {"wall_ms": wall_ms, "kernels": sum(d[1] for d in dev),
            "device_ms": dev_ms, "busy": dev_ms / wall_ms,
            "flash_ms": sum(d[2] for d in dev
                            if "flash_attention" in d[0]) / 1e3,
            "scatter_ms": sum(d[2] for d in dev
                              if "stream_scatter_add" in d[0]) / 1e3,
            "scatter_kernels": sum(d[1] for d in dev
                                   if "stream_scatter_add" in d[0]),
            "top": [(k[:name_len], c, t / 1e3) for k, c, t in top]}


@contextlib.contextmanager
def first_calls(flash_seen: dict, moe_seen: list):
    """Within the block, keep the first flash call of each shape (its inputs
    and the kernel's output) and the last MoE layer's (params, input): held
    against the plain version and the CPU after the counted prefill. The
    clones launch no counted kernel."""
    from repro_torch.kernels import ops
    from repro_torch.models import moe as moe_mod

    flash0, moe0 = ops.flash_attention, moe_mod.apply_moe

    def flash_hook(q, k, v, *, causal=True, window=None):
        out = flash0(q, k, v, causal=causal, window=window)
        key = (tuple(q.shape), tuple(k.shape), causal, window)
        if key not in flash_seen:
            flash_seen[key] = (q.clone(), k.clone(), v.clone(), out.clone())
        return out

    def moe_hook(p, x, spec):
        moe_seen[:] = [(p, x.clone())]
        return moe0(p, x, spec)

    ops.flash_attention, moe_mod.apply_moe = flash_hook, moe_hook
    try:
        yield
    finally:
        ops.flash_attention, moe_mod.apply_moe = flash0, moe0


def flash_calls_check(arch: str, flash_seen: dict) -> str:
    """Each kept flash call of a prefill against the plain version on the
    same card tensors, at the bf16 tolerance of phase 10."""
    import torch

    from repro_torch.kernels import ref

    tol, parts = 2e-2, []
    for (qs, ks, causal, window), (q, k, v, out) in flash_seen.items():
        plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = (out.float() - plain.float()).abs().max().item()
        check(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol),
              f"{arch}: flash at q {qs} k {ks} causal={causal} != plain "
              f"(max abs {err:.3e}, tolerance {tol})")
        parts.append(f"q {list(qs)} k {list(ks)} causal={causal} "
                     f"{err:.3e}")
    return "; ".join(parts)


def moe_capacity_check(arch: str, spec, p, x) -> str:
    """One MoE layer at the configured capacity in f32 (TF32 off), on the
    card and on the same inputs on the CPU: the chosen experts and the
    dispatch slots (so the dropped set) equal, some token dropped, y within
    MOE_CAP_ATOL."""
    import torch

    from repro_torch.models import moe as moe_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    e, k = spec.n_experts, spec.top_k
    cap = moe_mod.capacity(x.shape[1], spec)
    got = {}
    for dev in ("cuda", "cpu"):
        pd = {n: t.detach().to(dev, torch.float32) for n, t in p.items()}
        xd = x.to(dev, torch.float32)
        _, eidx = moe_mod.route(torch.softmax(xd @ pd["router"], -1), k)
        _, slot, _ = moe_mod._dispatch(xd, eidx, e, k, cap)
        y = moe_mod.apply_moe(pd, xd, spec).y
        got[dev] = (eidx.cpu(), slot.cpu(), y.cpu())
        del pd, xd
    (e_c, s_c, y_c), (e_h, s_h, y_h) = got["cuda"], got["cpu"]
    dropped = int((s_h == e * cap).sum())
    check(torch.equal(e_c, e_h), f"{arch}: MoE experts differ, card vs CPU")
    check(torch.equal(s_c, s_h), f"{arch}: MoE dispatch slots differ, card "
          "vs CPU")
    check(dropped > 0, f"{arch}: no token dropped at capacity {cap}: the "
          "check's precondition")
    err = (y_c - y_h).abs().max().item()
    check(err <= MOE_CAP_ATOL, f"{arch}: MoE y card vs CPU {err:.3e} "
          f"(limit {MOE_CAP_ATOL})")
    return (f"MoE layer f32 at capacity {cap} ({spec.capacity_factor}), card "
            f"vs CPU: experts and slots equal, {dropped} of {s_h.numel()} "
            f"assignments dropped, y max abs err {err:.3e} (max |y| "
            f"{y_h.abs().max().item():.3f}, limit {MOE_CAP_ATOL})")


def attention_layers(cfg) -> int:
    """Flash launches one prefill makes: one per self- or cross-attention
    layer call (the hybrid's shared block once a super-block)."""
    from repro_torch.models import transformer as tf

    if cfg.xlstm:
        return 0
    if cfg.family == "hybrid":
        return tf.n_super(cfg)
    return cfg.n_layers


def family_cell(arch: str, layers, B: int, card: str) -> int:
    """One config through the checks and timings of phase 16, then, for
    the VLM, hybrid, xLSTM and audio cells, its grid case on the same
    weights (``serve_grid_family``); returns the flash launches of its
    first prefill and of the grid's counted prefill."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import next_token
    from repro_torch.models import transformer as tf

    full = configs.get(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    T = FAMILY_T
    torch.cuda.reset_peak_memory_stats()
    t_cell = t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen)
    torch.cuda.synchronize()
    n_params = tf.param_count(params)
    draw_s = time.perf_counter() - t0
    audio = cfg.family == "audio"
    img = None
    if audio:      # frame embeddings [B, T, d], the encoder's input
        inp = torch.randn((B, T + 1, cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16)
    else:
        toks, _ = make_lm_tokens(cfg.vocab, B, T + 1, seed=1)
        inp = torch.from_numpy(np.asarray(toks, np.int32)).cuda()
    if cfg.family == "vlm":
        img = torch.randn((B, cfg.n_image_tokens, cfg.d_model),
                          generator=gen, device="cuda").to(torch.bfloat16)
    prompt, last = inp[:, :T], inp[:, T:T + 1]
    cache_len = T + FAMILY_NEW + 8

    def run_prefill():
        return tf.prefill(params, cfg, prompt, cache_len, image_embeds=img)

    # counts reset just before the first prefill, read just after it
    flash_seen, moe_seen = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with first_calls(flash_seen, moe_seen):
        logits0, _ = run_prefill()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    flash_line = flash_calls_check(arch, flash_seen)
    del flash_seen
    moe_line = ""
    if moe_seen:
        moe_line = "; " + moe_capacity_check(arch, cfg.moe, *moe_seen[0])
        del moe_seen
        torch.cuda.empty_cache()
    want = attention_layers(cfg)
    check(counts["flash_attention"] == want,
          f"{arch}: a prefill launched flash_attention "
          f"{counts['flash_attention']} times for {want} attention layers")
    times = []
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lg, state = run_prefill()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        outs.append(lg)
    prefill_ms = min(times)
    same = bits_equal(outs[0], outs[1]) and bits_equal(outs[0], logits0)
    check(same, f"{arch}: two prefills of one batch differ")
    finite = bool(torch.isfinite(logits0).all())
    check(finite and tuple(logits0.shape) == (B, 1, cfg.vocab),
          f"{arch}: prefill logits {tuple(logits0.shape)}, finite={finite}")

    decode_ms, tokens = None, None
    if audio:
        try:
            tf.decode_step(params, cfg, last, state)
            check(False, f"{arch}: the encoder took a decode step")
        except ValueError:
            pass
    else:
        tok = next_token(outs[1])
        gen_toks = [tok]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(FAMILY_NEW - 1):
            lg, state = tf.decode_step(params, cfg, tok, state)
            tok = next_token(lg)
            gen_toks.append(tok)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t1) * 1e3 / (FAMILY_NEW - 1)
        tokens = torch.cat(gen_toks, 1).cpu()
        check(bool(torch.isfinite(lg).all())
              and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab,
              f"{arch}: decode logits not finite or tokens out of range")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    prof_prefill = profiled(run_prefill)
    prof_decode = None
    if not audio:
        _, st = run_prefill()
        tok = next_token(outs[1])
        prof_decode = profiled(lambda: tf.decode_step(params, cfg, tok, st))
        del st

    # the reference's contract: forward over T + 1 against prefill(T) + one
    # decode step, in bf16 within FAMILY_TOL (the encoder has no decode
    # step, and its prefill is forward's last position)
    def contract(c, p):
        emb = tf.embed_tokens(p, c, inp)
        h, _ = tf.forward(p, c, emb, image_embeds=img)
        want_l = h[:, -1:] @ tf.lm_head_weight(p, c)
        _, st = tf.prefill(p, c, prompt, cache_len, image_embeds=img)
        got, _ = tf.decode_step(p, c, last, st)
        return got.float(), want_l.float()

    del state, outs, logits0
    line = "none (encoder-only)"
    if not audio:
        got, want_l = contract(cfg, params)
        err = (got - want_l).abs().max().item()
        scale = want_l.abs().max().item()
        tol = FAMILY_TOL * max(1.0, scale)
        line = (f"max abs err {err:.3e} (max |logit| {scale:.3f}, "
                f"tolerance {tol:.3e})")
    if cfg.family == "moe":
        # capacity drops differ between T and T + 1 tokens, and in bf16 a
        # last-token expert choice flips on a bf16 ulp of the router input
        # (top-k is not continuous). So MoE holds the contract as the
        # reference's own test does: no token dropped (capacity_factor
        # E / top_k: capacity >= T), in f32 (TF32 off) at full width, to
        # that test's allclose; the bf16 gap at the configured capacity is
        # printed, not held.
        wide32 = dataclasses.replace(cfg, dtype="float32", moe=(
            dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                / cfg.moe.top_k)))
        del params
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        params = tf.init_params(wide32, torch.Generator(
            device="cuda").manual_seed(0))
        g32, w32 = contract(wide32, params)
        err32 = (g32 - w32).abs().max().item()
        excess = ((g32 - w32).abs() - MOE_F32_RTOL * w32.abs()).max().item()
        check(excess <= MOE_F32_ATOL,
              f"{arch}: f32 forward(T+1) vs prefill(T) + decode, no drop: "
              f"|diff| exceeds {MOE_F32_RTOL} |want| by {excess:.3e} "
              f"(atol {MOE_F32_ATOL})")
        line = (f"held in f32 with no drop: max abs err {err32:.3e}, "
                f"excess over {MOE_F32_RTOL} |want| {excess:.3e} (atol "
                f"{MOE_F32_ATOL}); bf16, not held: {err:.3e} at capacity "
                f"factor {cfg.moe.capacity_factor} (max |logit| "
                f"{scale:.3f})")
    elif not audio:
        check(err <= tol, f"{arch}: forward(T+1) vs prefill(T) + decode "
              f"differ by {err:.3e} (tolerance {tol:.3e})")

    what = "encode" if audio else "prefill"
    print(f"[families] {cfg.name} on {card}: {cfg.n_layers} of "
          f"{full.n_layers} layers at full width (d_model {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} hd {cfg.hd}), "
          f"{n_params} parameters ({n_params * 2 / 1e9:.2f} GB bf16) drawn "
          f"in {draw_s:.1f} s; B={B} T={T}: {what} {prefill_ms:.3f} ms "
          f"(runs {[round(x, 3) for x in times]}), decode "
          + (f"{decode_ms:.3f} ms a step" if decode_ms is not None
             else "none (encoder-only: ValueError)")
          + f", flash launches a prefill {counts['flash_attention']}, "
          f"bit-equal prefills {same}, peak memory {peak_gib:.2f} GiB; "
          + "contract forward(T+1) vs prefill(T)+decode " + line
          + f"; flash calls vs plain: {flash_line or 'none'}" + moe_line,
          flush=True)
    print(f"[families] {cfg.name} profiled {what}: wall "
          f"{prof_prefill['wall_ms']:.3f} ms, {prof_prefill['kernels']} "
          f"kernels, device {prof_prefill['device_ms']:.3f} ms (busy "
          f"{prof_prefill['busy']:.1%}), flash "
          f"{prof_prefill['flash_ms']:.3f} ms; top: " + "; ".join(
              f"{k} x{c} {t:.3f} ms" for k, c, t in prof_prefill["top"])
          + ("" if prof_decode is None else
             f"; decode step: wall {prof_decode['wall_ms']:.3f} ms, "
             f"{prof_decode['kernels']} kernels, device "
             f"{prof_decode['device_ms']:.3f} ms (busy "
             f"{prof_decode['busy']:.1%})")
          + ("" if tokens is None else
             f"; greedy tokens row 0 {tokens[0].tolist()}")
          + f"; the cell took {time.perf_counter() - t_cell:.1f} s",
          flush=True)
    grid_flash = (serve_grid_family(card, cfg, params, B)
                  if arch in GRID_FAMILIES else 0)
    del params, inp, img
    return counts["flash_attention"] + grid_flash


def families_phase(card: str) -> dict:
    """Every LM family at full width through init_params -> prefill ->
    decode_step on the card; returns the flash launches of the cells'
    first prefills."""
    import torch

    t0 = time.perf_counter()
    total = {"flash_attention": 0}
    for arch, layers, B in FAMILY_CELLS:
        total["flash_attention"] += family_cell(arch, layers, B, card)
        gc.collect()                 # free one config before the next
        torch.cuda.empty_cache()
    total["flash_attention"] += serve_grid_moe(card)
    serve_tp_layers(card)
    serve_family_layers(card)
    print(f"[families] phase 16 took {time.perf_counter() - t0:.1f} s on "
          f"{card}; flash launches {total['flash_attention']} over "
          f"{len(FAMILY_CELLS)} first prefills and "
          f"{len(GRID_FAMILIES) + 1} grid prefills", flush=True)
    return total


# -------------------------------------- serving over a grid ([lm], [families])
# launch/tp_serve.py through launch/serve.py's steps over (data 1, model 2)
# with both positions on cuda:0, against the one-card steps on the same
# weights: Yi-6B whole in [lm], DeepSeek-MoE-16B (8 layers) in [families]
SERVE_TP_T = 1024               # prompt tokens a row
SERVE_TP_CACHE = 1048           # LMAdapter's cache_len at T 1024 and 16 new:
                                # 524 slots a position
SERVE_TP_NEW = 16               # Yi-6B's teacher-forced decode steps
SERVE_TP_MOE_NEW = 4            # DeepSeek-MoE-16B's
# the layer checks: one decode attention layer at full width in f32 (TF32
# off) on a cache of 4,096 slots split over two positions (2,048 each),
# against decode_self_attention on the whole cache; rows whose new slot
# lies on position 0, on position 1, at the last slot of position 0 and the
# first of position 1
SERVE_TP_S = 4096
SERVE_TP_LENGTHS = (100, 3000, 2047, 2048)
# about 2x the readings on an H100 80GB HBM3 at 700 W (Yi-6B, Granite-20B,
# the window, int8): |y - want| over max |want| 1.086e-06; the cache's
# written entries 2.384e-06 (an int8 cache: equal)
SERVE_TP_TOL = 2.2e-6
SERVE_TP_CACHE_TOL = 4.8e-6
# DeepSeek-MoE-16B over the grid in f32 (TF32 off) against the one card:
# |logit gap| over max(1, max |logit|), about 2x the reading (2.95e-06 at
# the prefill). In bf16 it is not held: a bf16 ulp of the router's input
# moves a top-6 near tie of 64 experts, and every row of the 4 routed its
# token otherwise in some layer from the first decode step on
SERVE_TP_MOE_F32_TOL = 6e-6
# the VLM, hybrid, xLSTM and audio cells of [families] over the same grid,
# on each cell's weights: a 1,024-token prompt (frames) into 1,040 slots,
# 520 a position, and 4 teacher-forced decode steps
SERVE_FAMILY_CACHE = 1040
SERVE_FAMILY_NEW = 4
GRID_FAMILIES = ("llama32_vision_90b", "zamba2_7b", "xlstm_125m",
                 "hubert_xlarge")
# the families' layer checks (serve_family_layer): the VLM's cross read over
# Llama-3.2-Vision's 1,024 image tokens, split 2 x 512; (y, state)
# tolerances of max |want|, about 2.5x the readings on an H100 80GB HBM3 at
# 700 W (cross 1.009e-06; the mixer 6.240e-08, its state and conv tail
# equal, held at 1e-7; sLSTM 7.012e-08 / 2.890e-07; mLSTM 2.827e-07 /
# 3.104e-07; the tied head 1.944e-07)
SERVE_TP_IMAGE = 1024
SERVE_FAMILY_TOL = {"cross": (2.6e-6, 0.0), "ssm": (1.6e-7, 1e-7),
                    "slstm": (1.8e-7, 7.3e-7), "mlstm": (7.1e-7, 7.8e-7),
                    "tied": (4.9e-7, 0.0)}


def serve_grid_lm(cuda0):
    """A ``(data 1, model 2)`` mesh with both positions on ``cuda0`` and
    its explicit grid."""
    from repro_torch.launch import mesh as tmesh

    return (tmesh.LogicalMesh((1, 2), ("data", "model"), "cuda:0"),
            [((cuda0, cuda0), range(0, 1))])


def serve_state_bytes(cfg, mesh, B: int, cache_len: int) -> int:
    """The decode state's bytes on the card when both of ``mesh``'s model
    positions lie there, from ``specs.input_pspecs`` alone
    (``dryrun.shard_bytes`` a position, times 2)."""
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import logical_rules

    shape = specs.InputShape("serve", cache_len, B, "decode")
    leaves = specs._state_leaves(specs.input_specs(cfg, shape)["state"])
    pspecs = specs.input_pspecs(cfg, shape, logical_rules(mesh))["state"]
    return 2 * sum(dryrun.shard_bytes(x.shape, x.dtype, spec, mesh.shape)
                   for x, spec in zip(leaves, pspecs))


def relayout_bytes(cfg, B: int, T: int, m: int = 2,
                   layers: int | None = None) -> int:
    """The K/V bytes the grid prefill's relayout moves between positions,
    from the shapes: each of ``layers`` attention layers' (default every
    layer) K and V, each position's ``K/m`` KV heads at every prompt slot
    (image token) that another position holds."""
    per = cfg.n_kv_heads // m * cfg.hd * (2 if cfg.dtype == "bfloat16"
                                          else 4)
    return (cfg.n_layers if layers is None else layers) * 2 * B * per * (
        m - 1) * T


def state_bytes(state) -> dict:
    """A grid state's bytes: the self-attention K/V, the cross K/V and the
    recurrent states (whole on every position), over every position."""
    def size(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    return {"kv": size(t for g in state.caches for layer in g for c in layer
                       for t in (c.k, c.v)),
            "cross": size(t for g in state.cross_kv or [] for layer in g
                          for kv in layer for t in kv),
            "recurrent": size(t for g in state.recurrent or [] for layer in g
                              for leaf in layer for t in leaf)}


def serve_grid_case(tag: str, card: str, cfg, params, B: int, n_decode: int,
                    *, tol: float = FAMILY_TOL, hold: bool = True,
                    kv_bytes: int | None = None, moved: int | None = None,
                    cache_len: int = SERVE_TP_CACHE, img=None,
                    frames=None, held_bytes: dict | None = None) -> int:
    """``params`` (one card, bf16) served over ``(data 1, model 2)`` on
    ``cuda:0`` through ``launch/serve.py``'s steps: a prefill of B x
    SERVE_TP_T (``frames`` for the encoder; the VLM with its image
    embeddings ``img``) into ``cache_len`` slots (counts reset before, read
    after: flash once an attention layer a position, each new flash shape
    against the plain version), the bytes placed (parameters:
    ``param_specs``; the state: ``input_pspecs``, ``kv_bytes`` of K/V and
    ``held_bytes``' cross K/V and recurrent states when given), the
    relayout's moved bytes (``moved``), the prefill logits and
    ``n_decode`` teacher-forced decode steps against the one card's within
    ``tol`` * max(1, max |logit|), the greedy tokens (a differing token
    must be a near tie of the one card's top two logits; neither held but
    printed unless ``hold``), two decodes from one cloned state bit-equal
    (the encoder: its decode raises); times and peak beside the one card's.
    Returns the counted prefill's flash launches."""
    import numpy as np
    import torch

    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp, serve, tp_serve

    cuda0 = torch.device("cuda", 0)
    t_case = time.perf_counter()
    if frames is None:
        toks, _ = make_lm_tokens(cfg.vocab, B, SERVE_TP_T, seed=3)
        prompt = torch.from_numpy(np.asarray(toks, np.int32)).cuda()
    else:
        prompt = frames
    pre = serve.make_prefill_step(cfg, cache_len)
    dec = serve.make_decode_step(cfg)
    encoder = cfg.family == "audio"

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the one card: its logits at the prefill and each decode step, fed its
    # own greedy tokens (after a warm-up prefill, as the grid's is timed
    # after its counted one)
    pre(params, prompt, img)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    route1 = [[] for _ in range(n_decode + 1)]
    with routings(route1[0]):
        (l1, st1), pre_ms1 = timed(lambda: pre(params, prompt, img))
    want, fed = [l1.float()], []
    dec_ms1 = 0.0
    for i in range(n_decode):
        fed.append(serve.next_token(want[-1]))
        with routings(route1[i + 1]):
            (lg, st1), ms = timed(lambda: dec(params, fed[-1], st1))
        dec_ms1 += ms
        want.append(lg.float())
    peak1 = (torch.cuda.max_memory_allocated() - base) / 2**30
    del st1

    mesh, grid_ = serve_grid_lm(cuda0)
    lm, (placed, _) = placed_bytes(lambda: fsdp.shard(params, mesh,
                                                      groups=grid_))
    predicted = grid_bytes_on(cfg, mesh, grid_, cuda0)
    check(placed == predicted, f"{tag}: {placed} parameter bytes placed, "
          f"param_specs predicts {predicted}")
    flash_seen = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    route2 = [[] for _ in range(n_decode + 1)]
    with first_calls(flash_seen, []), tp_traffic(lm) as tally, \
            routings(route2[0]):
        l2, st2 = pre(lm, prompt, img)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    flash_line = flash_calls_check(tag, flash_seen) or "none"
    del flash_seen
    n_flash = 2 * attention_layers(cfg)
    check(counts["flash_attention"] == n_flash,
          f"{tag}: the grid prefill launched flash_attention "
          f"{counts['flash_attention']} times, not once an attention layer "
          f"a position ({n_flash})")
    if encoder:
        check(st2 is None, f"{tag}: the encoder's grid prefill returned a "
              "state")
        sizes, held, want_state = {}, 0, 0
    else:
        check(isinstance(st2, tp_serve.GridState) and st2.split,
              f"{tag}: the grid state's cache is not split by sequence")
        sizes = state_bytes(st2)
        held = sum(t.numel() * t.element_size()
                   for t in tp_serve.state_tensors(st2))
        want_state = serve_state_bytes(cfg, mesh, B, cache_len)
    check(held == want_state, f"{tag}: the state holds {held} B, "
          f"input_pspecs predicts {want_state}")
    check(kv_bytes is None or sizes["kv"] == kv_bytes,
          f"{tag}: {sizes.get('kv')} K/V bytes, hand count {kv_bytes}")
    for key, n in (held_bytes or {}).items():
        check(sizes[key] == n, f"{tag}: {sizes[key]} B of {key} state, "
              f"hand count {n}")
    check(moved is None or tally["relayout"] == moved,
          f"{tag}: the relayout moved {tally['relayout']} B, hand count "
          f"{moved}")

    def bound(w):
        return tol * max(1.0, w.abs().max().item())

    # a row whose token went to other experts in some layer (a top-k near
    # tie moved by a bf16 ulp of the router's input) is reported from then
    # on, not held: top-k is not continuous
    apart = torch.zeros(B, dtype=torch.bool)
    flips = []

    def held_gap(i, lg):
        """The largest gap over the rows still routed alike (over every
        row unless ``hold``)."""
        apart[:] |= rerouted(route1[i], route2[i], B)
        if apart.any():
            flips.append((i, apart.nonzero().flatten().tolist()))
        keep = (~apart if hold else torch.ones_like(apart)).to(lg.device)
        gap = (lg.float() - want[i]).abs()[keep]
        return gap.max().item() if gap.numel() else 0.0

    gaps = [held_gap(0, l2)]
    check(not hold or gaps[0] <= bound(want[0]), f"{tag}: grid prefill "
          f"logits differ "
          f"from the one card's by {gaps[0]:.3e} (bound "
          f"{bound(want[0]):.3e})")
    clone = None if encoder else tp_serve.clone_state(st2)
    got_tok, ties, dec_ms2 = [serve.next_token(l2)], [], 0.0
    for i, tok in enumerate(fed):
        with routings(route2[i + 1]):
            (lg, st2), ms = timed(lambda: dec(lm, tok, st2))
        dec_ms2 += ms
        gaps.append(held_gap(i + 1, lg))
        check(not hold or gaps[-1] <= bound(want[i + 1]),
              f"{tag}: decode step {i + 1} logits differ from the one "
              f"card's by {gaps[-1]:.3e} (bound {bound(want[i + 1]):.3e})")
        got_tok.append(serve.next_token(lg))
    check(not hold or int(apart.sum()) < B, f"{tag}: every row was "
          "routed otherwise: nothing held")
    peak2 = (torch.cuda.max_memory_allocated() - base) / 2**30
    ref_tok = fed + [serve.next_token(want[-1])]
    for i, (a, b) in enumerate(zip(got_tok, ref_tok)):
        for r in torch.nonzero(a[:, 0] != b[:, 0]).flatten().tolist():
            if apart[r]:
                ties.append((i, r, "rerouted"))
                continue
            top2 = torch.topk(want[i][r, -1], 2).values
            gap = (top2[0] - top2[1]).item()
            check(not hold or gap <= bound(want[i]), f"{tag}: step {i} "
                  f"row {r} token "
                  f"{int(a[r])} != the one card's {int(b[r])}, whose top "
                  f"two logits are {gap:.3e} apart (bound "
                  f"{bound(want[i]):.3e}): not a near tie")
            ties.append((i, r, gap))
    if encoder:
        try:
            dec(lm, got_tok[0], st2)
            check(False, f"{tag}: the encoder took a grid decode step")
        except ValueError:
            pass
        same = "none (encoder: its grid decode raises ValueError)"
    else:
        # two decodes from one cloned state
        (la, sa), (lb, sb) = [dec(lm, fed[0], tp_serve.clone_state(clone))
                              for _ in range(2)]
        same = bits_equal(la, lb) and all(
            bits_equal(x, y) for x, y in zip(tp_serve.state_tensors(sa),
                                             tp_serve.state_tensors(sb)))
        check(same, f"{tag}: two grid decodes from one state differ")
        del sa, sb
    _, pre_ms2 = timed(lambda: pre(lm, prompt, img))
    steps = (f"{n_decode} teacher-forced decode steps max "
             f"{max(gaps[1:]):.3e}" if n_decode else "no decode")
    print(f"[{tag}] grid serving (data 1, model 2) of {cfg.name} on {card}: "
          f"parameters {placed} B placed (param_specs {predicted}); prefill "
          f"B={B} T={SERVE_TP_T} into {cache_len} slots: flash "
          f"{counts['flash_attention']} launches, state {held} B "
          f"(input_pspecs {want_state}; K/V {sizes.get('kv')} B, cross "
          f"K/V {sizes.get('cross')} B, recurrent {sizes.get('recurrent')} "
          f"B over the 2 positions), relayout moved {tally['relayout']} B"
          f"{'' if moved is None else f' (hand count {moved})'}; logits "
          f"vs the one card: prefill {gaps[0]:.3e}, {steps} ("
          f"{'bound' if hold else 'not held; would be'} "
          f"{tol} * max(1, max |logit|) = {bound(want[0]):.3e}); "
          f"rows routed otherwise (step, rows) {flips or 'none'}; "
          f"greedy tokens equal at {sum(bool(torch.equal(a, b)) for a, b in zip(got_tok, ref_tok))} "
          f"of {len(ref_tok)} steps, near ties {ties}; two decodes "
          f"bit-equal {same}; prefill {pre_ms2:.3f} ms (one card "
          f"{pre_ms1:.3f}), decode "
          f"{dec_ms2 / max(n_decode, 1):.3f} ms a step (one card "
          f"{dec_ms1 / max(n_decode, 1):.3f}), peak {peak2:.2f} GiB above "
          f"the weights (one card {peak1:.2f}); flash calls vs plain: "
          f"{flash_line}; the case took "
          f"{time.perf_counter() - t_case:.1f} s", flush=True)
    del lm, st2, clone
    gc.collect()
    torch.cuda.empty_cache()
    return counts["flash_attention"]


@contextlib.contextmanager
def routings(rec: list):
    """Within the block, each MoE router call appends its rows' last
    token's experts (sorted, ``[B, k]``) to ``rec``: a layer a call, on
    the one card and on the grid alike (position 0 routes)."""
    from repro_torch.models import moe as moe_mod

    real = moe_mod.router

    def spy(p, x, spec):
        out = real(p, x, spec)
        rec.append(out[2][:, -1].sort(-1).values.clone())
        return out

    moe_mod.router = spy
    try:
        yield
    finally:
        moe_mod.router = real


def rerouted(a: list, b: list, rows: int):
    """``[B]`` bool: the rows whose last token goes to other experts in some
    layer of two runs' routings (:func:`routings`)."""
    import torch

    out = torch.zeros(rows, dtype=torch.bool)
    for x, y in zip(a, b):
        out |= (x != y).any(-1).cpu()
    return out


def serve_grid_yi6b(card: str, params=None) -> int:
    """[lm]'s grid case: Yi-6B whole (``params``: [lm]'s, else drawn from
    seed 0), 16 teacher-forced decode steps; the K/V and relayout bytes
    against the hand counts."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = configs.get("yi_6b")
    if params is None:
        params = tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))
    B = 4
    kv = cfg.n_layers * 2 * B * SERVE_TP_CACHE * cfg.n_kv_heads * cfg.hd * 2
    return serve_grid_case("lm", card, cfg, params, B, SERVE_TP_NEW,
                           kv_bytes=kv,
                           moved=relayout_bytes(cfg, B, SERVE_TP_T))


def serve_grid_moe(card: str) -> int:
    """[families]' grid case: DeepSeek-MoE-16B, 8 of 28 layers, 4
    teacher-forced decode steps, in bf16 (the logits printed, not held: a
    routing near tie moves; module docstring) and in f32 (TF32 off) within
    ``SERVE_TP_MOE_F32_TOL``. Returns the bf16 prefill's flash launches."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(configs.get("deepseek_moe_16b"), n_layers=8)
    B, out = 4, 0
    torch.backends.cuda.matmul.allow_tf32 = False
    for c in (cfg, dataclasses.replace(cfg, dtype="float32")):
        params = tf.init_params(c, torch.Generator(device="cuda").manual_seed(
            0))
        f32 = c.dtype == "float32"
        n = serve_grid_case(
            "families" + (" f32" if f32 else ""), card, c, params, B,
            SERVE_TP_MOE_NEW, tol=SERVE_TP_MOE_F32_TOL if f32 else FAMILY_TOL,
            hold=f32, moved=relayout_bytes(c, B, SERVE_TP_T))
        out = out or n
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_grid_family(card: str, cfg, params, B: int) -> int:
    """[families]' grid case of a VLM, hybrid, xLSTM or audio cell, on the
    cell's weights and depth (``serve_grid_case``): a prompt of B x
    SERVE_TP_T (the encoder: seeded frames; the VLM: seeded image
    embeddings) into SERVE_FAMILY_CACHE slots, SERVE_FAMILY_NEW decode
    steps, the state's bytes against hand counts from the shapes: the self
    K/V (every attention call's K and V of every slot), the cross K/V
    (every image token), the recurrent states whole on both positions, and
    the relayout (each attention layer's, the cross layers' along the image
    tokens). Returns the grid prefill's flash launches."""
    import torch

    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm as xlstm_mod

    S, bf16, f32 = SERVE_FAMILY_CACHE, 2, 4
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = img = None
    if cfg.family == "audio":
        frames = torch.randn((B, SERVE_TP_T, cfg.d_model), generator=gen,
                             device="cuda").to(torch.bfloat16)
    if cfg.family == "vlm":
        img = torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=gen,
                          device="cuda").to(torch.bfloat16)
    calls = attention_layers(cfg) - (tf.n_super(cfg) if cfg.family == "vlm"
                                     else 0)
    kv = calls * 2 * B * S * cfg.n_kv_heads * cfg.hd * bf16
    held, moved = {}, None
    if cfg.family == "vlm":
        held["cross"] = (tf.n_super(cfg) * 2 * B * cfg.n_image_tokens
                         * cfg.n_kv_heads * cfg.hd * bf16)
        moved = (relayout_bytes(cfg, B, SERVE_TP_T, layers=calls)
                 + relayout_bytes(cfg, B, cfg.n_image_tokens,
                                  layers=tf.n_super(cfg)))
    elif cfg.family == "hybrid":
        _, n_heads, conv_ch = ssm_mod.dims(cfg.d_model, cfg.ssm)
        spec = cfg.ssm
        held["recurrent"] = 2 * cfg.n_layers * B * (
            n_heads * spec.d_state * spec.head_dim * f32
            + (spec.d_conv - 1) * conv_ch * bf16)
        moved = relayout_bytes(cfg, B, SERVE_TP_T, layers=calls)
    elif cfg.xlstm:
        _, dh = xlstm_mod._cell_dims(cfg.d_model, cfg.n_heads)
        h = cfg.n_heads
        held["recurrent"] = 2 * B * h * f32 * (
            (cfg.n_layers + 1) // 2 * 4 * dh
            + cfg.n_layers // 2 * (dh * dh + dh + 1))
    if cfg.family == "audio":
        kv = None
    out = serve_grid_case(
        "families", card, cfg, params, B,
        0 if cfg.family == "audio" else SERVE_FAMILY_NEW, kv_bytes=kv,
        moved=moved, cache_len=S, img=img, frames=frames, held_bytes=held)
    del frames, img
    return out


def serve_family_layer(card: str, name: str) -> str:
    """One layer of a family at full width (f32, TF32 off) over ``(data 1,
    model 2)`` on ``cuda:0`` against its one-device function, output and
    state (``SERVE_FAMILY_TOL``, of max |want|): ``cross`` one VLM cross
    read over SERVE_TP_IMAGE image tokens split 2 x 512 against
    ``decode_cross_attention``; ``ssm`` one Zamba2 mixer, SERVE_FAMILY_NEW
    decode steps from a state prefilled over 256 tokens, against
    ``ssd_decode_step``; ``slstm`` / ``mlstm`` one xLSTM-125M cell each, the
    same, against ``slstm_forward`` / ``mlstm_decode_step``; ``tied`` the
    tied head's logits against ``final_norm(h) @ embed.T``."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch import fsdp, tp, tp_serve
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.layers import apply_norm

    arch = {"cross": "llama32_vision_90b", "ssm": "zamba2_7b"}.get(
        name, "xlstm_125m")
    over = {"cross": dict(n_layers=2, cross_attn_every=1),
            "ssm": dict(n_layers=1, shared_attn_every=1)}.get(
        name, dict(n_layers=2))
    cfg = dataclasses.replace(configs.get(arch), d_ff=512, dtype="float32",
                              **({} if name == "tied" else {"vocab": 512}),
                              **over)
    gen = torch.Generator(device="cuda").manual_seed(6)
    model = tf.init_params(cfg, gen)
    mesh, grid_ = serve_grid_lm(torch.device("cuda", 0))
    lm = fsdp.shard(model, mesh, groups=grid_)
    view = tp.GridView(lm, 0)
    st = tp.Stream(view.devices, 1)
    B, d = 4, cfg.d_model

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    errs, state_errs = [], []
    with torch.inference_mode():
        if name == "cross":
            n = SERVE_TP_IMAGE
            k, v = randn(B, n, cfg.n_kv_heads, cfg.hd), randn(
                B, n, cfg.n_kv_heads, cfg.hd)
            x = randn(B, 1, d)
            want = attn.decode_cross_attention(
                dict(model.cross_blocks[0]["attn"].items()), x, (k, v),
                n_heads=cfg.n_heads, hd=cfg.hd)
            [parts] = tp_serve.grid_cross(
                [view], "cross_blocks.0.attn.", [[x, x]],
                [[(k[:, :n // 2], v[:, :n // 2]),
                  (k[:, n // 2:], v[:, n // 2:])]], cfg, False)
            got = tp.all_reduce(parts)[0]
            errs.append(rel(got, want))
        elif name == "tied":
            h = randn(B, 1, d)
            got = tp_serve.logits(view, cfg, [h, h])
            want = apply_norm(model.final_norm, h, cfg.norm) @ model.embed.T
            errs.append(rel(got, want))
        else:
            xp = randn(B, 256, d)
            if name == "ssm":
                bp, prefix = model.ssm_blocks[0][0], "ssm_blocks.0.0."
                hn = apply_norm(bp["norm"], xp, cfg.norm)
                _, s0 = ssm_mod.ssd_forward(bp["ssm"], hn, cfg.ssm)
                one = ssm_mod.SSMCache(s0, tf._conv_tail(hn, bp["ssm"], cfg))
            else:
                is_s = name == "slstm"
                bp = (model.slstm if is_s else model.mlstm)[0]
                prefix = f"{name}.0."
                run = (xlstm_mod.slstm_forward if is_s
                       else xlstm_mod.mlstm_forward)
                _, one = run(bp, xp, cfg.n_heads)
            states = [tp_serve.rebuild(one, [t.clone() for t in one])
                      for _ in range(2)]
            for _ in range(SERVE_FAMILY_NEW):
                x = randn(B, 1, d)
                if name == "ssm":
                    y, one = ssm_mod.ssd_decode_step(
                        bp["ssm"], apply_norm(bp["norm"], x, cfg.norm), one,
                        cfg.ssm)
                    xs, states = tp_serve.ssm_decode(view, prefix, cfg, st,
                                                     [x, x], states)
                else:
                    y, one = (xlstm_mod.slstm_forward(bp, x, cfg.n_heads,
                                                      cache=one) if is_s
                              else xlstm_mod.mlstm_decode_step(
                                  bp, x, one, cfg.n_heads))
                    xs, states = tp_serve.xlstm_decode(view, prefix, cfg, st,
                                                       [x, x], states)
                errs.append(rel(xs[0], x + y))
                state_errs.append(max(rel(a, b) for a, b in zip(states[0],
                                                                 one)))
                check(all(bits_equal(a, b) for a, b in zip(*states)),
                      f"[serve_tp] {name}: the positions' state copies "
                      "differ")
    err = max(errs)
    state_err = max(state_errs) if state_errs else 0.0
    check(err <= SERVE_FAMILY_TOL[name][0]
          and state_err <= SERVE_FAMILY_TOL[name][1],
          f"[serve_tp] {name}: grid vs one device {err:.3e} of max |want|, "
          f"state {state_err:.3e} (tolerances {SERVE_FAMILY_TOL[name]})")
    del model, lm
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{name} ({cfg.name}) {err:.3e}"
            + (f" (state {state_err:.3e})" if state_errs else ""))


def serve_family_layers(card: str) -> None:
    """The families' layer checks (``serve_family_layer``)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    lines = [serve_family_layer(card, name)
             for name in ("cross", "ssm", "slstm", "mlstm", "tied")]
    print(f"[serve_tp] family layers over (data 1, model 2) on {card}, "
          f"f32, {SERVE_FAMILY_NEW} decode steps from a 256-token prefill: "
          + "; ".join(lines) + f" (tolerances (y, state) of max |want|: "
          f"{SERVE_FAMILY_TOL}); {time.perf_counter() - t0:.1f} s",
          flush=True)


def serve_tp_layer(card: str, name: str, cfg) -> str:
    """One decode attention layer of ``cfg`` (1 layer, f32, TF32 off) over
    ``(data 1, model 2)`` on ``cuda:0`` with the cache split by sequence
    (``tp_serve.grid_attention``, partials all-reduced) against
    ``decode_self_attention`` on the whole cache: random cache contents, the
    rows' lengths ``SERVE_TP_LENGTHS``; the output and the cache after the
    write within ``SERVE_TP_TOL`` of max |want| and ``SERVE_TP_CACHE_TOL``
    (an int8 cache equal)."""
    import torch

    from repro_torch.launch import fsdp, tp, tp_serve
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf

    cuda0 = torch.device("cuda", 0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = tf.init_params(cfg, gen)
    mesh, grid_ = serve_grid_lm(cuda0)
    lm = fsdp.shard(model, mesh, groups=grid_)
    B, S, K, hd = len(SERVE_TP_LENGTHS), SERVE_TP_S, cfg.n_kv_heads, cfg.hd
    if cfg.kv_dtype == "int8":
        k = torch.randint(-127, 128, (B, S, K, hd), generator=gen,
                          device="cuda").to(torch.int8)
        v = torch.randint(-127, 128, (B, S, K, hd), generator=gen,
                          device="cuda").to(torch.int8)
    else:
        k = torch.randn((B, S, K, hd), generator=gen, device="cuda")
        v = torch.randn((B, S, K, hd), generator=gen, device="cuda")
    lengths = torch.tensor(SERVE_TP_LENGTHS, dtype=torch.int32,
                           device="cuda")
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device="cuda")
    half = S // 2
    with torch.inference_mode():
        one = attn.KVCache(k=k.clone(), v=v.clone(), length=lengths.clone())
        want, _ = attn.decode_self_attention(
            dict(model.blocks[0]["attn"].items()), x, one,
            n_heads=cfg.n_heads, n_kv=K, hd=hd, rope=cfg.rope,
            window=cfg.window)
        caches = [attn.KVCache(k=k[:, j * half:(j + 1) * half].clone(),
                               v=v[:, j * half:(j + 1) * half].clone(),
                               length=lengths.clone()) for j in range(2)]
        [parts] = tp_serve.grid_attention(
            [tp.GridView(lm, 0)], "blocks.0.attn.", [[x, x]], [caches], cfg,
            S, False)
        got = tp.all_reduce(parts)[0]
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / scale
    ck = torch.cat([c.k for c in caches], 1)
    cv = torch.cat([c.v for c in caches], 1)
    if cfg.kv_dtype == "int8":
        cache_err = float(not (torch.equal(ck, one.k)
                               and torch.equal(cv, one.v)))
    else:
        cache_err = max((ck - one.k).abs().max().item(),
                        (cv - one.v).abs().max().item())
    check(err <= SERVE_TP_TOL and cache_err <= SERVE_TP_CACHE_TOL
          and all(torch.equal(c.length, one.length) for c in caches),
          f"[serve_tp] {name}: grid decode attention vs "
          f"decode_self_attention {err:.3e} of max |y| {scale:.3f}, cache "
          f"{cache_err:.3e} (tolerances {SERVE_TP_TOL}, "
          f"{SERVE_TP_CACHE_TOL})")
    del model, lm, k, v, one, caches
    gc.collect()
    torch.cuda.empty_cache()
    return f"{name} {err:.3e} (cache {cache_err:.3e})"


def serve_tp_layers(card: str) -> None:
    """The layer checks: Yi-6B (GQA 32 / 4), Granite-20B (MQA 48 / 1, more
    positions than KV heads), Llama-4-Scout's attention width with its
    windowed variant's window cut to 512, Yi-6B with an int8 cache; each at
    full attention width, one layer, a 512-wide MLP and vocab (which the
    layer does not read)."""
    import dataclasses

    import torch

    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()

    def small(arch, **over):
        return dataclasses.replace(configs.get(arch), n_layers=1, d_ff=512,
                                   vocab=512, dtype="float32", **over)

    lines = [serve_tp_layer(card, name, cfg) for name, cfg in (
        ("yi_6b", small("yi_6b")),
        ("granite_20b", small("granite_20b")),
        ("llama4_scout window 512", small("llama4_scout_17b_a16e",
                                          family="dense", moe=None,
                                          window=512)),
        ("yi_6b int8 cache", small("yi_6b", kv_dtype="int8")))]
    print(f"[serve_tp] decode attention layer over (data 1, model 2) on "
          f"{card}, f32, cache {SERVE_TP_S} slots split 2 x "
          f"{SERVE_TP_S // 2}, new slots at {list(SERVE_TP_LENGTHS)}: "
          + "; ".join(lines) + f" (tolerances {SERVE_TP_TOL} of max |y|, "
          f"{SERVE_TP_CACHE_TOL} the cache); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------- a batch of one row over the whole grid
# long_500k's decode (one row): the idle batch axes fold into the cache's
# sequence split (launch/tp_serve.py, specs.folds), so over (data 2, model
# 2) on cuda:0 the cache splits over the four cells in input_pspecs'
# data-major order and every data group runs the row
LONG_SLOTS = 524288             # long_500k's cache: 131,072 slots a cell
LONG_FILL = 262140              # seeded slots; the 8 steps write 262,140-147,
LONG_NEW = 8                    # across cell 1 (g 0, j 1) | cell 2 (g 1, j 0)
LONG_PEAK_GIB = 75
LONG_T, LONG_CACHE = 3068, 4096     # (b): 1,024 slots a cell, the prompt on
                                    # three cells, the steps into cell 3
# (c): one decode attention layer, f32 (TF32 off), at Yi-6B's width over
# the four cells of a 4,096-slot cache (1,024 each), window 512; the new
# slot at the last of cell 1, the first of cell 2 (the data groups'
# boundary), and two where the window straddles that boundary
LONG_LAYER_WINDOW = 512
LONG_LAYER_LENGTHS = (2047, 2048, 2200, 2500)


def long_grid_lm(cuda0):
    """A ``(data 2, model 2)`` mesh with every cell on ``cuda0`` and its
    explicit grid (one data position a group)."""
    from repro_torch.launch import mesh as tmesh

    return (tmesh.LogicalMesh((2, 2), ("data", "model"), "cuda:0"),
            [((cuda0, cuda0), range(g, g + 1)) for g in range(2)])


def long_state_bytes(cfg, mesh, cache_len: int) -> int:
    """A one-row decode state's bytes on the card when every cell of
    ``mesh`` lies there, from ``specs.input_pspecs`` under the rewritten
    rules (``dryrun.step_rules``) alone: ``dryrun.shard_bytes`` a cell,
    times the cells."""
    from repro_torch.launch import dryrun, specs

    shape = specs.InputShape("long_500k", cache_len, 1, "decode")
    rules = dryrun.step_rules(mesh, shape, None)
    leaves = specs._state_leaves(specs.input_specs(cfg, shape)["state"])
    pspecs = specs.input_pspecs(cfg, shape, rules)["state"]
    return math.prod(mesh.shape.values()) * sum(
        dryrun.shard_bytes(x.shape, x.dtype, spec, mesh.shape)
        for x, spec in zip(leaves, pspecs))


def long_fill(cfg, length: int, seed: int):
    """A one-row one-device decode state of ``LONG_SLOTS`` slots on the
    card: each layer's first ``length`` K/V slots drawn from ``seed`` (the
    rest zero), the lengths at ``length``."""
    import torch

    from repro_torch.models import transformer as tf

    state = tf.init_decode_state(cfg, 1, LONG_SLOTS, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.inference_mode():
        for c in state.caches:
            for x in (c.k, c.v):
                x[:, :length].normal_(generator=gen)
            c.length.fill_(length)
    return state


def held_near_ties(tag: str, got: list, want: list, bound) -> list:
    """The steps and rows whose greedy token differs from the one card's,
    each a near tie of the one card's top two logits (checked)."""
    import torch

    from repro_torch.launch import serve

    ties = []
    for i, (a, w) in enumerate(zip(got, want)):
        ta, tw = serve.next_token(a), serve.next_token(w)
        for r in torch.nonzero(ta[:, 0] != tw[:, 0]).flatten().tolist():
            top2 = torch.topk(w[r, -1], 2).values
            gap = (top2[0] - top2[1]).item()
            check(gap <= bound(w), f"{tag}: step {i} row {r} token "
                  f"{int(ta[r])} != the one card's {int(tw[r])}, whose top "
                  f"two logits are {gap:.3e} apart: not a near tie")
            ties.append((i, r, gap))
    return ties


def serve_long_yi6b(card: str, params=None) -> None:
    """(a) Yi-6B whole (``params``: [lm]'s bf16 weights, else drawn from
    seed 0), its long-context
    variant (window 8,192), one row over ``LONG_SLOTS`` slots: first the
    one card's ``LONG_NEW`` teacher-forced decode steps from a seeded fill
    of ``LONG_FILL`` slots (its cache then freed), then the same fill
    placed over ``(data 2, model 2)`` on ``cuda:0`` (``place_state``):
    parameter bytes against ``param_specs``, the state's against
    ``input_pspecs`` under the rewritten rules and the hand count
    (34,359,738,880 B), the logits of every step against the one card's
    within ``FAMILY_TOL`` * max(1, max |logit|), greedy tokens, decode ms
    a step beside the one card's, the peak."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import fsdp, serve, tp_serve
    from repro_torch.models import transformer as tf

    cuda0 = torch.device("cuda", 0)
    t_case = time.perf_counter()
    cfg = configs.get("yi_6b").long_context_variant()
    dec = serve.make_decode_step(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(9)
    tok = torch.randint(0, cfg.vocab, (1, 1), generator=gen, device="cuda",
                        dtype=torch.int32)

    def run(model, state, feed=None):
        """``LONG_NEW`` steps fed ``feed``, else the model's own greedy
        tokens: logits, tokens fed, ms a step, the state."""
        out, fed, ms = [], [], []
        t = tok
        for i in range(LONG_NEW):
            t = t if feed is None else feed[i]
            fed.append(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, state = dec(model, t, state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(lg.float())
            t = serve.next_token(lg)
        return out, fed, ms, state

    if params is None:
        params = tf.init_params(configs.get("yi_6b"), torch.Generator(
            device="cuda").manual_seed(0))
    one = long_fill(cfg, LONG_FILL, 11)
    want, fed1, ms1, one = run(params, one)
    lengths1 = int(one.caches[0].length[0])
    # where a step's time goes: one more step of each, profiled
    extra = serve.next_token(want[-1])
    prof1 = profiled(lambda: dec(params, extra, one), top=4, name_len=60)
    del one
    gc.collect()
    torch.cuda.empty_cache()

    mesh, grid_ = long_grid_lm(cuda0)
    lm, (placed, _) = placed_bytes(lambda: fsdp.shard(params, mesh,
                                                      groups=grid_))
    predicted = grid_bytes_on(cfg, mesh, grid_, cuda0)
    check(placed == predicted, f"[lm] (a): {placed} parameter bytes placed, "
          f"param_specs predicts {predicted}")
    state = tp_serve.place_state(lm, cfg, long_fill(cfg, LONG_FILL, 11))
    gc.collect()
    held = sum(t.numel() * t.element_size()
               for t in tp_serve.state_tensors(state))
    want_state = long_state_bytes(cfg, mesh, LONG_SLOTS)
    esize = torch.empty((), dtype=tf.DTYPES[cfg.dtype]).element_size()
    kv = cfg.n_layers * 2 * (LONG_SLOTS // 4) * cfg.n_kv_heads * cfg.hd * esize
    hand = 4 * kv + 4 * cfg.n_layers * 4
    check(state.folded and held == want_state == hand == 34_359_738_880,
          f"[lm] (a): the grid state holds {held} B, input_pspecs under the "
          f"rewritten rules predict {want_state}, the hand count {hand}")
    cells = [[tuple(tp_serve.slots(2 * g + j, 4, LONG_SLOTS)) for j in
              range(2)] for g in range(2)]
    got, fed2, ms2, state = run(lm, state, fed1)
    lengths2 = [int(c.length[0]) for g in state.caches for c in g[0]]
    prof2 = profiled(lambda: dec(lm, extra, state), top=4, name_len=60)
    peak = torch.cuda.max_memory_allocated() / 2**30

    def bound(w):
        return FAMILY_TOL * max(1.0, w.abs().max().item())

    gaps = [(a - w).abs().max().item() for a, w in zip(got, want)]
    for i, (g_, w) in enumerate(zip(gaps, want)):
        check(g_ <= bound(w), f"[lm] (a): decode step {i + 1} logits differ "
              f"from the one card's by {g_:.3e} (bound {bound(w):.3e})")
    check(all(torch.equal(a, b) for a, b in zip(fed1, fed2)),
          "[lm] (a): the grid was fed other tokens than the one card")
    check(lengths2 == [lengths1] * 4 == [LONG_FILL + LONG_NEW] * 4,
          f"[lm] (a): lengths {lengths2} after the steps, one card "
          f"{lengths1}")
    check(peak <= LONG_PEAK_GIB, f"[lm] (a): peak {peak:.2f} GiB")
    ties = held_near_ties("[lm] (a)", got, want, bound)
    print(f"[lm] (a) long_500k decode of {cfg.name} (window {cfg.window}, "
          f"bf16) on {card}: one row over {LONG_SLOTS} slots, the first "
          f"{LONG_FILL} seeded, {LONG_NEW} teacher-forced steps writing "
          f"slots {LONG_FILL}-{LONG_FILL + LONG_NEW - 1}; (data 2, model 2) "
          f"on cuda:0, cells' slots {cells}; parameters {placed} B placed "
          f"(param_specs {predicted}); state {held} B (input_pspecs under "
          f"the rewritten rules {want_state}, hand count {hand}); logits vs "
          f"the one card max {max(gaps):.3e} (bound {FAMILY_TOL} * max(1, "
          f"max |logit|) = {bound(want[0]):.3e}); near ties {ties}; decode "
          f"{statistics.median(ms2):.3f} ms a step (median; one card "
          f"{statistics.median(ms1):.3f}; steps {[round(x, 3) for x in ms2]}"
          f" vs {[round(x, 3) for x in ms1]}); peak {peak:.2f} GiB (limit "
          f"{LONG_PEAK_GIB}); the case took "
          f"{time.perf_counter() - t_case:.1f} s", flush=True)
    for what, prof in (("one card", prof1), ("grid", prof2)):
        print(f"[lm] (a) profiled decode step {LONG_NEW + 1}, {what}: wall "
              f"{prof['wall_ms']:.3f} ms, {prof['kernels']} kernels, device "
              f"{prof['device_ms']:.3f} ms (busy {prof['busy']:.1%}); top: "
              + "; ".join(f"{k} x{c} {t:.3f} ms" for k, c, t in prof["top"]),
              flush=True)
    del lm, state, got, want
    gc.collect()
    torch.cuda.empty_cache()


def serve_long_layers(card: str) -> int:
    """(b) Yi-6B at full width and 2 layers, bf16, long-context variant,
    one row: a prompt of ``LONG_T`` tokens into ``LONG_CACHE`` slots over
    ``(data 2, model 2)`` on ``cuda:0`` through ``serve.make_prefill_step``
    (counts reset before, read after: flash once a layer on every cell,
    each group running the prompt; each flash shape against the plain
    version), state bytes against ``input_pspecs`` under the rewritten
    rules, the prefill and ``LONG_NEW`` teacher-forced decode steps across
    slot 3,072 (cell 2 | cell 3) against the one card's within
    ``FAMILY_TOL`` * max(1, max |logit|), two decodes from one cloned
    state bit-equal. (c) the layer check (``LONG_LAYER_*``) in f32 against
    ``decode_self_attention`` within ``SERVE_TP_TOL`` /
    ``SERVE_TP_CACHE_TOL``. Returns (b)'s flash launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.data import make_lm_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp, serve, tp_serve
    from repro_torch.models import transformer as tf

    cuda0 = torch.device("cuda", 0)
    t_case = time.perf_counter()
    cfg = dataclasses.replace(configs.get("yi_6b"), n_layers=2
                              ).long_context_variant()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0))
    toks, _ = make_lm_tokens(cfg.vocab, 1, LONG_T, seed=4)
    prompt = torch.from_numpy(np.asarray(toks, np.int32)).cuda()
    pre = serve.make_prefill_step(cfg, LONG_CACHE)
    dec = serve.make_decode_step(cfg)
    l1, one = pre(params, prompt)
    want, fed = [l1.float()], []
    for _ in range(LONG_NEW):
        fed.append(serve.next_token(want[-1]))
        lg, one = dec(params, fed[-1], one)
        want.append(lg.float())
    del one
    mesh, grid_ = long_grid_lm(cuda0)
    lm = fsdp.shard(params, mesh, groups=grid_)
    flash_seen = {}
    ops.reset_launch_counts()
    with first_calls(flash_seen, []):
        l2, state = pre(lm, prompt)
    n_flash = ops.launch_counts()["flash_attention"]
    flash_line = flash_calls_check("[lm] (b)", flash_seen)
    hand = 4 * cfg.n_layers
    check(n_flash == hand, f"[lm] (b): the folded prefill launched flash "
          f"{n_flash} times, hand count {hand} (once a layer a cell: every "
          f"group runs the prompt)")
    held = sum(t.numel() * t.element_size()
               for t in tp_serve.state_tensors(state))
    want_state = long_state_bytes(cfg, mesh, LONG_CACHE)
    check(state.folded and held == want_state, f"[lm] (b): the state holds "
          f"{held} B, input_pspecs under the rewritten rules {want_state}")
    clone = tp_serve.clone_state(state)
    got = [l2.float()]
    for t in fed:
        lg, state = dec(lm, t, state)
        got.append(lg.float())

    def bound(w):
        return FAMILY_TOL * max(1.0, w.abs().max().item())

    gaps = [(a - w).abs().max().item() for a, w in zip(got, want)]
    for i, (g_, w) in enumerate(zip(gaps, want)):
        check(g_ <= bound(w), f"[lm] (b): step {i} logits differ from the "
              f"one card's by {g_:.3e} (bound {bound(w):.3e})")
    ties = held_near_ties("[lm] (b)", got, want, bound)
    (la, sa), (lb, sb) = [dec(lm, fed[0], tp_serve.clone_state(clone))
                          for _ in range(2)]
    same = bits_equal(la, lb) and all(
        bits_equal(x, y) for x, y in zip(tp_serve.state_tensors(sa),
                                         tp_serve.state_tensors(sb)))
    check(same, "[lm] (b): two grid decodes from one state differ")
    cells = [tuple(tp_serve.slots(c, 4, LONG_CACHE)) for c in range(4)]
    print(f"[lm] (b) {cfg.name} full width, {cfg.n_layers} layers, bf16, "
          f"window {cfg.window}, one row on {card}: prompt {LONG_T} into "
          f"{LONG_CACHE} slots over (data 2, model 2) on cuda:0, cells' "
          f"slots {cells}; flash {n_flash} launches (hand count {hand}); "
          f"flash calls vs plain: {flash_line}; state {held} B "
          f"(input_pspecs {want_state}); logits vs the one card: prefill "
          f"{gaps[0]:.3e}, {LONG_NEW} decode steps max {max(gaps[1:]):.3e} "
          f"(bound {bound(want[0]):.3e}); near ties {ties}; two decodes "
          f"bit-equal {same}; the case took "
          f"{time.perf_counter() - t_case:.1f} s", flush=True)
    del params, lm, state, clone, sa, sb
    gc.collect()
    torch.cuda.empty_cache()
    serve_long_layer(card)
    return n_flash


def serve_long_layer(card: str) -> None:
    """(c) one decode attention layer of Yi-6B's width (1 layer, f32, TF32
    off, window ``LONG_LAYER_WINDOW``) over ``(data 2, model 2)`` on
    ``cuda:0``, the row's cache of ``SERVE_TP_S`` slots split over the four
    cells (``tp_serve.grid_attention``, each group's partials all-reduced),
    against ``decode_self_attention`` on the whole cache, one row at each
    of ``LONG_LAYER_LENGTHS``: the output (both groups' bit-equal) within
    ``SERVE_TP_TOL`` of max |want| and the cache after the write within
    ``SERVE_TP_CACHE_TOL``."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch import fsdp, tp, tp_serve
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda0 = torch.device("cuda", 0)
    cfg = dataclasses.replace(configs.get("yi_6b"), n_layers=1, d_ff=512,
                              vocab=512, dtype="float32",
                              window=LONG_LAYER_WINDOW)
    gen = torch.Generator(device="cuda").manual_seed(12)
    model = tf.init_params(cfg, gen)
    mesh, grid_ = long_grid_lm(cuda0)
    lm = fsdp.shard(model, mesh, groups=grid_)
    views = [tp.GridView(lm, g) for g in range(2)]
    S, K, hd, per = SERVE_TP_S, cfg.n_kv_heads, cfg.hd, SERVE_TP_S // 4
    lines, worst = [], (0.0, 0.0)
    p = dict(model.blocks[0]["attn"].items())
    for length in LONG_LAYER_LENGTHS:
        k = torch.randn((1, S, K, hd), generator=gen, device="cuda")
        v = torch.randn((1, S, K, hd), generator=gen, device="cuda")
        lengths = torch.tensor([length], dtype=torch.int32, device="cuda")
        x = torch.randn((1, 1, cfg.d_model), generator=gen, device="cuda")
        with torch.inference_mode():
            one = attn.KVCache(k=k.clone(), v=v.clone(),
                               length=lengths.clone())
            want, _ = attn.decode_self_attention(
                p, x, one, n_heads=cfg.n_heads, n_kv=K, hd=hd,
                rope=cfg.rope, window=cfg.window)
            caches = [[attn.KVCache(
                k=k[:, c * per:(c + 1) * per].clone(),
                v=v[:, c * per:(c + 1) * per].clone(),
                length=lengths.clone()) for c in (2 * g, 2 * g + 1)]
                for g in range(2)]
            partss = tp_serve.grid_attention(
                views, "blocks.0.attn.", [[x, x], [x, x]], caches, cfg, S,
                True)
            outs = [tp.all_reduce(parts)[0] for parts in partss]
        scale = want.abs().max().item()
        err = (outs[0] - want).abs().max().item() / scale
        cells = [c for g in caches for c in g]
        cache_err = max((torch.cat([c.k for c in cells], 1) - one.k).abs()
                        .max().item(),
                        (torch.cat([c.v for c in cells], 1) - one.v).abs()
                        .max().item())
        check(bits_equal(outs[0], outs[1]), f"[serve_tp] (c) length "
              f"{length}: the two data groups' outputs differ")
        check(err <= SERVE_TP_TOL and cache_err <= SERVE_TP_CACHE_TOL
              and all(torch.equal(c.length, one.length) for c in cells),
              f"[serve_tp] (c) length {length}: grid decode attention vs "
              f"decode_self_attention {err:.3e} of max |y| {scale:.3f}, "
              f"cache {cache_err:.3e} (tolerances {SERVE_TP_TOL}, "
              f"{SERVE_TP_CACHE_TOL})")
        reading = [c for c in range(4)
                   if c * per <= length
                   and (c + 1) * per - 1 >= length - cfg.window + 1]
        lines.append(f"slot {length} (cells read {reading}) {err:.3e} "
                     f"(cache {cache_err:.3e})")
        worst = max(worst[0], err), max(worst[1], cache_err)
    print(f"[serve_tp] (c) folded decode attention layer, {cfg.name} width, "
          f"f32, window {cfg.window}, one row over (data 2, model 2) on "
          f"{card}, cache {S} slots split 4 x {per}: " + "; ".join(lines)
          + f"; max {worst[0]:.3e} / {worst[1]:.3e} (tolerances "
          f"{SERVE_TP_TOL}, {SERVE_TP_CACHE_TOL}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del model, lm, views
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------ phase 17: train
TRAIN_LR = 0.01
# Yi-6B's depth in the f32 cases held against the CPU ([train] parity, the
# [cuda:0, cpu] steps and (g); [fl_train] (b), (d), (e)): one layer covers
# every leaf kind, and the CPU's share of the smoke's time is its largest
PARITY_LAYERS = 1
TRAIN_PARITY_B, TRAIN_PARITY_T = 2, 2048    # two attend_chunked chunks
TRAIN_B, TRAIN_T = 4, 4096      # Yi-6B: train_4k's length, 4 rows a card
TRAIN_STEPS = 2         # 5 before the tensor-parallel cases joined, 3
                        # before the FL encode in place did
TRAIN_FAMILY_T = 1024           # the families' tokens (frames) a row,
TRAIN_XLSTM_T = 512             # but xLSTM's: its sLSTM steps on the host
# Yi-6B at full width in f32 (TF32 off), card vs CPU: the loss,
# each gradient leaf's max |diff| over its max |g|, the params after one
# step; n_micro = 2 against 1 on the card, per leaf likewise. About 2x the
# readings on an H100 80GB HBM3 at 700 W: 9.537e-07, 1.281e-05 (wq),
# 1.192e-07 (an ulp of the norm scales at 1.0), 1.069e-05 (wq)
TRAIN_LOSS_TOL = 2e-6
TRAIN_GRAD_REL = 2.6e-5
TRAIN_PARAM_TOL = 2.4e-7
TRAIN_MICRO_REL = 2.2e-5
TRAIN_SHARD_T = 256     # the [cuda:0, cpu] step: its CPU group's row
TP_T = 256              # (g): the [cuda:0, cpu] grid's step
# (f) Yi-6B whole in bf16 over (data 1, model 2) on cuda:0 against the
# one-card step: the loss, the params after one step (max |diff|, and the
# share of elements apart: a bf16 parameter whose update differs in the
# last bits rounds to its neighbour). About 2x the readings on an H100 80GB
# HBM3 at 700 W: 7.915e-05; 2.441e-04 (one bf16 ulp of embed's values in
# [1/32, 1/16)); 1,390,054 of 6,061,035,520 elements (2.29e-4)
TP_LOSS_TOL = 1.6e-4
TP_PARAM_TOL = 4.9e-4
TP_MOVED_SHARE = 4.6e-4
# the families at reduced width in f32, card vs CPU: the CPU parity tests'
# tolerances (tests/test_torch_train_families.py)
FAMILY_TRAIN_LOSS_TOL, FAMILY_TRAIN_GRAD_REL = 2e-5, 1e-4


@contextlib.contextmanager
def no_checkpoints():
    """Within the block the training forward saves every activation: the
    ``checkpoint`` that models.attention and models.transformer call runs
    the function directly."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf

    saved = attn.checkpoint, tf.checkpoint

    def direct(fn, *args, use_reentrant=None):
        return fn(*args)

    attn.checkpoint = tf.checkpoint = direct
    try:
        yield
    finally:
        attn.checkpoint, tf.checkpoint = saved


def grad_gap(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-leaf max |got - want| over the leaf's max |want|,
    and the leaf; ``got`` may lie on the card."""
    worst, where = 0.0, ""
    for name, w in want.items():
        w = w.float().cpu()
        err = (got[name].float().cpu() - w).abs().max().item()
        rel = err / max(w.abs().max().item(), 1e-30)
        if rel > worst:
            worst, where = rel, name
    return worst, where


def lm_batch(cfg, B: int, T: int, seed: int, device) -> dict:
    """A training batch on ``device``: ``make_lm_tokens`` tokens and labels
    (audio: seeded bf16-able frames instead of tokens; VLM: seeded image
    embeddings in the model dtype)."""
    import numpy as np
    import torch

    from repro_torch.data import make_lm_tokens
    from repro_torch.models import transformer as tf

    toks, labels = make_lm_tokens(cfg.vocab, B, T, seed=seed)
    batch = {"labels": torch.from_numpy(np.asarray(labels, np.int32))}
    gen = torch.Generator().manual_seed(seed)
    dtype = tf.DTYPES[cfg.dtype]
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, T, cfg.d_model),
                                      generator=gen).to(dtype)
    else:
        batch["tokens"] = torch.from_numpy(np.asarray(toks, np.int32))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.randn(
            (B, cfg.n_image_tokens, cfg.d_model), generator=gen).to(dtype)
    return {k: v.to(device) for k, v in batch.items()}


def train_parity(card: str):
    """Yi-6B at full width and PARITY_LAYERS layer(s), f32, TF32 off, B 2 x
    T 2048: the
    card against the CPU (loss, every gradient leaf, the params after one
    step), remat numerics-neutral, two steps from one state bit-equal,
    n_micro 2 against 1. The card's part runs here; the CPU's gradient and
    step then run on a worker thread (``on_host``) while the card runs on
    (``train_phase``). Returns the function that joins it and holds the
    card against the CPU."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("yi_6b"),
                              n_layers=PARITY_LAYERS,
                              dtype="float32")
    B, T = TRAIN_PARITY_B, TRAIN_PARITY_T
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    cpu_model = tf.init_params(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_batch = lm_batch(cfg, B, T, 3, "cpu")
    batch = {k: v.cuda() for k, v in cpu_batch.items()}
    state0 = {n: p.detach().clone() for n, p in model.named_parameters()}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = ttrain.step_gradients(model, cfg, batch)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    check(ops.launch_counts()["flash_attention"] == 0,
          "a training step launched the flash kernel")

    # without the per-block and per-chunk checkpoints: the same numbers
    with no_checkpoints():
        loss_r, grads_r = ttrain.step_gradients(model, cfg, batch)
    remat_same = (bits_equal(loss_r, loss)
                  and all(bits_equal(grads_r[n], g) for n, g in grads.items()))
    del grads_r
    # n_micro = 2: the f32 sums of two halves against one batch
    loss_m, grads_m = ttrain.step_gradients(model, cfg, batch, 2)
    micro_loss = abs(loss_m.item() - loss.item())
    micro_rel, micro_at = grad_gap(grads_m, grads)
    del grads_m

    # two make_dense_train_step steps from one state
    step = ttrain.make_dense_train_step(cfg, lr=TRAIN_LR)
    _, l1 = step(model, batch)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state0[n])
    _, l2 = step(model, batch)
    steps_same = bits_equal(l1, l2) and all(
        bits_equal(after[n], p) for n, p in model.named_parameters())
    moved = sum(int((p != state0[n]).sum())
                for n, p in model.named_parameters())
    n_params = tf.param_count(model)
    # what the CPU's comparison needs, on the host; the card freed
    loss = loss.item()
    grads = {n: g.float().cpu() for n, g in grads.items()}
    params = [p.detach().cpu() for p in model.parameters()]
    del model, state0, after, batch
    gc.collect()
    torch.cuda.empty_cache()

    def cpu_step():
        t0 = time.perf_counter()
        cpu_loss, cpu_grads = ttrain.step_gradients(cpu_model, cfg,
                                                    cpu_batch)
        cpu_s = time.perf_counter() - t0
        # the CPU's step: the same two parts on its gradient
        ttrain.sgd_update(cpu_model, cpu_grads, TRAIN_LR)
        return cpu_loss.item(), cpu_grads, cpu_s

    job = on_host(cpu_step)

    def finish() -> None:
        cpu_loss, cpu_grads, cpu_s = job()
        loss_err = abs(loss - cpu_loss)
        grad_rel, grad_at = grad_gap(grads, cpu_grads)
        param_err = max((p - q).abs().max().item() for p, q in zip(
            params, cpu_model.parameters()))
        print(f"[train] parity on {card}: {cfg.name} full width, "
              f"{cfg.n_layers} layer(s), f32 "
              f"(TF32 off), B={B} T={T} (2 attention chunks): loss card "
              f"{loss:.7f} CPU {cpu_loss:.7f} |diff| "
              f"{loss_err:.3e} (tolerance {TRAIN_LOSS_TOL}); gradients max "
              f"|diff| / max |g| {grad_rel:.3e} at {grad_at} (tolerance "
              f"{TRAIN_GRAD_REL}); params after one step max |diff| "
              f"{param_err:.3e} (tolerance {TRAIN_PARAM_TOL}, {moved} of "
              f"{n_params} elements moved); remat bit-equal "
              f"{remat_same}; two steps from one state bit-equal "
              f"{steps_same}; n_micro 2 vs 1: loss |diff| {micro_loss:.3e}, "
              f"gradients {micro_rel:.3e} at {micro_at} (tolerance "
              f"{TRAIN_MICRO_REL}); card gradient {card_ms:.1f} ms, CPU "
              f"{cpu_s:.1f} s (on a worker thread while the card trained)",
              flush=True)
        check(loss_err <= TRAIN_LOSS_TOL,
              f"train loss card vs CPU {loss_err:.3e}")
        check(grad_rel <= TRAIN_GRAD_REL,
              f"gradient {grad_at} card vs CPU {grad_rel:.3e} of its max |g|")
        check(param_err <= TRAIN_PARAM_TOL,
              f"params after one step card vs CPU {param_err:.3e}")
        check(remat_same, "the step without checkpoints differs from the "
              "step with them")
        check(steps_same, "two steps from one state differ on the card")
        check(micro_loss <= TRAIN_LOSS_TOL and micro_rel <= TRAIN_MICRO_REL,
              f"n_micro 2 vs 1: loss {micro_loss:.3e}, gradient {micro_at} "
              f"{micro_rel:.3e}")

    return finish


def on_host(fn):
    """``fn()`` started on a worker thread (a CPU-bound reference run the
    card does not wait for); the returned function joins it and returns
    its result, or raises what it raised."""
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    future = pool.submit(fn)
    pool.shutdown(wait=False)
    return future.result


def fsdp_bytes_on(cfg, mesh, positions: int, n_data: int) -> int:
    """The bytes a device holds after ``fsdp.shard`` places ``cfg`` on
    ``mesh`` with ``positions`` of its ``n_data`` data positions there,
    predicted from ``param_specs`` alone: a leaf whose spec names ``data``
    holds ``positions / n_data`` of its elements, any other leaf all."""
    from repro_torch import convert
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import logical_rules
    from repro_torch.models import transformer as tf

    meta = tf.init_params(cfg, device="meta")
    leaves = convert.reference_leaves(meta)
    specs = shd.param_specs({lf.path: lf.shape for lf in leaves},
                            logical_rules(mesh), shd.axis_sizes_of(mesh))
    named = dict(meta.named_parameters())
    total = 0
    for lf in leaves:
        split = any(e == "data" for e in tuple(specs[lf.path]))
        for n in lf.names:
            p = named[n]
            nbytes = p.numel() * p.element_size()
            total += nbytes * positions // n_data if split else nbytes
    return total


def train_sharded_parity(card: str) -> None:
    """Yi-6B at full width and PARITY_LAYERS layer(s), f32, TF32 off, B 2 x
    T
    TRAIN_SHARD_T, ``data 2`` on ``[cuda:0, cpu]``: the bytes placed on the
    card against ``param_specs``' prediction, then one dense step against
    the one-card step with ``n_micro`` 2 (each group one row)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("yi_6b"),
                              n_layers=PARITY_LAYERS,
                              dtype="float32")
    mesh = tmesh.LogicalMesh((2, 1), ("data", "model"), ["cuda:0", "cpu"])
    gc.collect()
    torch.cuda.empty_cache()

    def held():
        # the bytes asked of the caching allocator and what it counts as
        # allocated (a cached block it did not split counts whole)
        return (torch.cuda.memory_stats()["requested_bytes.all.current"],
                torch.cuda.memory_allocated())

    base = held()
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    lm = fsdp.shard(model, mesh)
    del model
    placed, allocated = (a - b for a, b in zip(held(), base))
    want = fsdp_bytes_on(cfg, mesh, 1, 2)
    n_params = tf.param_count(tf.init_params(cfg, device="meta"))
    on_card = {str(t.device) for t in lm.chunks[0].values()}
    on_cpu = {str(t.device) for t in lm.chunks[1].values()}
    batch = lm_batch(cfg, 2, TRAIN_SHARD_T, 3, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = fsdp.step_gradients(lm, cfg, batch)
    fsdp.sgd_update(lm, grads, TRAIN_LR)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    # the one-card step with two microbatches, from the same draw
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    loss_1, grads_1 = ttrain.step_gradients(model, cfg, batch, 2)
    ttrain.sgd_update(model, grads_1, TRAIN_LR)
    loss_err = abs(loss.item() - loss_1.item())
    rel, at = grad_gap({n: grads.full(n, "cuda") for n in grads_1}, grads_1)
    del grads, grads_1
    param_err = max((p - lm.full(n, "cuda")).abs().max().item()
                    for n, p in model.named_parameters())
    print(f"[train] sharded parity on {card}: {cfg.name} full width, "
          f"{cfg.n_layers} layer(s), f32 (TF32 off), data 2 on [cuda:0, cpu], B=2 "
          f"T={TRAIN_SHARD_T} (one row a group): cuda:0 holds {placed} bytes "
          f"after placement ({allocated} allocated), param_specs predict "
          f"{want} ({want / 4 / 1e6:.1f} M of {n_params / 1e6:.1f} M "
          f"parameters); chunks on "
          f"{sorted(on_card)} / {sorted(on_cpu)}; against the one-card step "
          f"at n_micro 2: loss {loss.item():.7f} vs {loss_1.item():.7f} "
          f"|diff| {loss_err:.3e} (tolerance {TRAIN_LOSS_TOL}), gradients "
          f"max |diff| / max |g| {rel:.3e} at {at} (tolerance "
          f"{TRAIN_GRAD_REL}), params max |diff| {param_err:.3e} (tolerance "
          f"{TRAIN_PARAM_TOL}); the sharded step {shard_s:.2f} s", flush=True)
    check(placed == want, f"cuda:0 holds {placed} bytes after placement, "
          f"param_specs predict {want}")
    check(0 <= allocated - want < 2**20 * len(lm.chunks[0]),
          f"the allocator counts {allocated} bytes for {want} placed")
    check(on_card == {"cuda:0"} and on_cpu == {"cpu"},
          f"chunks on {on_card} / {on_cpu}")
    check(loss_err <= TRAIN_LOSS_TOL, f"sharded loss {loss_err:.3e}")
    check(rel <= TRAIN_GRAD_REL, f"sharded gradient {at} {rel:.3e}")
    check(param_err <= TRAIN_PARAM_TOL, f"sharded params {param_err:.3e}")
    del lm, model, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_sharded_yi6b(card: str) -> dict:
    """Yi-6B whole, bf16, seed 0, B TRAIN_B x T TRAIN_T over two explicit
    groups on ``cuda:0`` (data 0 and 1 of a ``data 2`` layout): one dense
    step. Returns its loss, its params on the CPU, its peak bytes and the
    bytes of one gathered block and of ``lm_head``, for ``train_yi6b``."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    cfg = configs.get("yi_6b")
    cuda0 = torch.device("cuda", 0)
    groups = [(cuda0, range(0, 1)), (cuda0, range(1, 2))]
    mesh = tmesh.LogicalMesh((2, 1), ("data", "model"), "cuda:0")
    n_micro = ttrain.micro_batches(tf.param_count(tf.init_params(
        cfg, device="meta")))
    check(n_micro % 2 == 0, f"{cfg.name} takes n_micro {n_micro}: two "
          "groups cannot stand in for it")
    gc.collect()
    torch.cuda.empty_cache()
    lm = fsdp.shard(tf.init_params(cfg, torch.Generator(
        device="cuda").manual_seed(0)), mesh, groups=groups)
    batch = lm_batch(cfg, TRAIN_B, TRAIN_T, 0, "cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = ttrain.make_dense_train_step(cfg, lr=TRAIN_LR,
                                        n_micro=n_micro // 2)(lm, batch)[1]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    block = sum(math.prod(lm.shapes[n]) * 2 for n in lm.shapes
                if n.startswith("blocks.0.") and lm.dims[n] is not None)
    head = math.prod(lm.shapes["lm_head"]) * 2
    params = {n: lm.full(n, "cpu") for n in lm.shapes}
    print(f"[train] {cfg.name} whole, bf16, B={TRAIN_B} T={TRAIN_T} over two "
          f"groups on {card} (cuda:0 twice): one step {step_ms:.3f} ms, loss "
          f"{loss.item():.6f}, peak {peak / 2**30:.2f} GiB; a gathered block "
          f"{block / 1e9:.3f} GB, lm_head {head / 1e9:.3f} GB", flush=True)
    out = {"loss": loss.cpu(), "params": params, "peak": peak,
           "block": block, "head": head, "ms": step_ms}
    del lm, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grid_bytes_on(cfg, mesh, groups, device) -> int:
    """The bytes ``device`` holds after ``fsdp.shard`` places ``cfg`` on
    ``mesh``'s ``(data group, model position)`` grid ``groups``, predicted
    from ``param_specs`` alone: each distinct block of a leaf that a cell on
    ``device`` holds, one position's shard (``dryrun.shard_bytes``) times
    the group's data positions where the leaf splits over ``data``."""
    from repro_torch import convert
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import group_cells, logical_rules
    from repro_torch.models import transformer as tf

    meta = tf.init_params(cfg, device="meta")
    named = dict(meta.named_parameters())
    sizes = shd.axis_sizes_of(mesh)
    leaves = convert.reference_leaves(meta)
    specs = shd.param_specs({lf.path: lf.shape for lf in leaves},
                            logical_rules(mesh), sizes)
    total = 0
    for lf in leaves:
        spec = tuple(specs[lf.path])
        d_split, m_split = "data" in spec, "model" in spec
        per = dryrun.shard_bytes(lf.shape, named[lf.names[0]].dtype, spec,
                                 sizes)
        blocks = {(g if d_split else None, j if m_split else None,
                   len(pos) if d_split else 1)
                  for g, (devs, pos) in enumerate(groups)
                  for j, dev in enumerate(group_cells(devs))
                  if dev == device}
        total += per * sum(n for _, _, n in blocks)
    return total


def placed_bytes(make) -> tuple:
    """``make()``'s result and the bytes it left on the card: requested of
    the caching allocator, and what it counts as allocated."""
    import torch

    def held():
        return (torch.cuda.memory_stats()["requested_bytes.all.current"],
                torch.cuda.memory_allocated())

    gc.collect()
    torch.cuda.empty_cache()
    base = held()
    out = make()
    gc.collect()
    return out, tuple(a - b for a, b in zip(held(), base))


def train_tp_parity(card: str) -> None:
    """(g) Yi-6B at full width and PARITY_LAYERS layer(s), f32, TF32 off, B
    2 x T TP_T,
    ``(data 1, model 2)`` on ``[cuda:0, cpu]`` (``launch/tp.py``): the bytes
    placed on the card against ``param_specs``' prediction, then one dense
    step against the same grid with both positions on ``cuda:0``, within
    the card-vs-CPU parity tolerances."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("yi_6b"),
                              n_layers=PARITY_LAYERS,
                              dtype="float32")
    cuda0, cpu = torch.device("cuda", 0), torch.device("cpu")
    mesh = tmesh.LogicalMesh((1, 2), ("data", "model"), [["cuda:0", "cpu"]])
    groups = tmesh.participant_groups(mesh, None)
    check(groups == [((cuda0, cpu), range(0, 1))], f"the grid {groups}")

    def make():
        model = tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))
        return fsdp.shard(model, mesh)

    lm, (placed, allocated) = placed_bytes(make)
    want = grid_bytes_on(cfg, mesh, groups, cuda0)
    batch = lm_batch(cfg, 2, TP_T, 3, "cuda")
    out = {}
    for tag, grid_ in (("[cuda:0, cpu]", None),
                       ("[cuda:0, cuda:0]", [((cuda0, cuda0),
                                              range(0, 1))])):
        if grid_ is not None:
            lm = fsdp.shard(tf.init_params(cfg, torch.Generator(
                device="cuda").manual_seed(0)), mesh, groups=grid_)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = fsdp.step_gradients(lm, cfg, batch)
        fsdp.sgd_update(lm, grads, TRAIN_LR)
        torch.cuda.synchronize()
        out[tag] = {"s": time.perf_counter() - t0, "loss": loss.item(),
                    "grads": {n: grads.full(n, cuda0) for n in lm.shapes},
                    "params": {n: lm.full(n, cuda0) for n in lm.shapes},
                    "devices": sorted({str(t.device)
                                       for _, t in lm.tensors()})}
        del grads, lm
        gc.collect()
    a, b = out["[cuda:0, cpu]"], out["[cuda:0, cuda:0]"]
    loss_err = abs(a["loss"] - b["loss"])
    rel, at = grad_gap(a["grads"], b["grads"])
    param_err = max((a["params"][n] - p).abs().max().item()
                    for n, p in b["params"].items())
    print(f"[train] (g) tensor parallel on {card}: {cfg.name} full width, "
          f"{cfg.n_layers} layer(s), f32 (TF32 off), (data 1, model 2) on [cuda:0, cpu], B=2 "
          f"T={TP_T}: cuda:0 holds {placed} bytes after placement "
          f"({allocated} allocated), param_specs predict {want}; tensors on "
          f"{a['devices']}; against the same grid on [cuda:0, cuda:0]: loss "
          f"{a['loss']:.7f} vs {b['loss']:.7f} |diff| {loss_err:.3e} "
          f"(tolerance {TRAIN_LOSS_TOL}), gradients max |diff| / max |g| "
          f"{rel:.3e} at {at} (tolerance {TRAIN_GRAD_REL}), params max "
          f"|diff| {param_err:.3e} (tolerance {TRAIN_PARAM_TOL}); steps "
          f"{a['s']:.2f} s / {b['s']:.2f} s", flush=True)
    check(placed == want, f"(g) cuda:0 holds {placed} bytes after "
          f"placement, param_specs predict {want}")
    check(a["devices"] == ["cpu", "cuda:0"] and b["devices"] == ["cuda:0"],
          f"(g) tensors on {a['devices']} / {b['devices']}")
    check(loss_err <= TRAIN_LOSS_TOL, f"(g) loss {loss_err:.3e}")
    check(rel <= TRAIN_GRAD_REL, f"(g) gradient {at} {rel:.3e}")
    check(param_err <= TRAIN_PARAM_TOL, f"(g) params {param_err:.3e}")
    del out, a, b, batch
    gc.collect()
    torch.cuda.empty_cache()


def apart_by_leaf(got, want, top: int = 3) -> str:
    """The ``top`` parameters of two ``{name: tensor}`` sets with the most
    elements apart, each with its count and size (compared on the card)."""
    counts = []
    for n, w in want.items():
        g = got[n]
        counts.append((int((g.float() != w.to(g.device).float()).sum()),
                       n, w.numel()))
    counts.sort(reverse=True)
    return ", ".join(f"{n} {c} of {size}" for c, n, size in counts[:top])


def gap_on_card(got, want) -> tuple[float, int, int, str]:
    """(max |got - want|, elements apart, elements, the worst parameter) of
    two ``{name: tensor}`` sets, each pair compared on the card (``got``'s
    values there; ``want``'s moved there one parameter at a time)."""
    err, moved, total, worst = 0.0, 0, 0, ""
    for n, w in want.items():
        g = got[n]
        d = (g.float() - w.to(g.device).float()).abs()
        moved += int((d > 0).sum())
        total += d.numel()
        if d.max().item() > err:
            err, worst = d.max().item(), n
    return err, moved, total, worst


# (h) DeepSeek-MoE-16B at full width, 4 of 28 layers (8, the depth
# [families] runs, until the families' grid serving cases joined the
# smoke), in bf16, over (data 1, model 2) on cuda:0 against the
# one-card step: the loss, the params after one step (max |diff| and the
# share of elements apart), as (f). About 2x the readings on an H100 80GB
# HBM3 at 700 W at 8 layers: 1.984e-04; 2.441e-04 (one bf16 ulp of embed's
# values in [1/32, 1/16)); 2,426,077 of 5,122,328,576 elements (4.74e-4)
TP_MOE_LAYERS = 4
TP_MOE_LOSS_TOL = 4e-4
TP_MOE_PARAM_TOL = 4.9e-4
TP_MOE_MOVED_SHARE = 9.5e-4
TP_PEAK_GIB = 75          # the step's own peak, (f) to (j)
TP_MOE_LAYER_B, TP_MOE_LAYER_T = 2, 256     # the layer check's rows
ROUTED = ("wi_gate", "wi_up", "wo")


def moe_config(layers: int = TP_MOE_LAYERS):
    """DeepSeek-MoE-16B at its published widths, ``layers`` deep."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get("deepseek_moe_16b"),
                               n_layers=layers)


@contextlib.contextmanager
def tp_traffic(lm):
    """Tallies, while the block runs, the weight bytes a model position
    reads of another position's chunks (``GridView.chunk`` with ``i !=
    j``: ``across``, and ``expert_gathered`` of the routed expert leaves),
    the bytes the MoE exchange hands from one position to another (the
    pieces of each 5-D all-to-all that change position, forward and
    backward) with its calls, the bytes of position 0's routing broadcast
    (each token's expert ids and gates ``[B, T, k]`` to the other
    positions; the gates' gradients back), the scatters of a whole
    tensor from one position to the others (``scatter_calls``: what the
    blocks run on position 0 alone once handed back), and the K/V bytes the
    serving prefill's cache relayout hands from one position to another
    (``relayout``: the pieces of each 4-D all-to-all that change
    position)."""
    from repro_torch.launch import tp

    routed = {n for n in lm.shapes
              if ".moe." in n and n.rsplit(".", 1)[1] in ROUTED}
    k = lm.cfg.moe.top_k if lm.cfg.moe is not None else None
    tally = {"across": 0, "expert_gathered": 0, "exchange": 0,
             "exchange_calls": 0, "route": 0, "scatter_calls": 0,
             "relayout": 0}
    chunk, fwd, bwd = (tp.GridView.chunk, tp._AllToAll.forward,
                       tp._AllToAll.backward)
    bfwd, bbwd = tp._Broadcast.forward, tp._Broadcast.backward
    sfwd = tp._Scatter.forward

    def spy_chunk(self, j, name, i, *args):
        t = chunk(self, j, name, i, *args)
        if i != j:
            tally["across"] += t.numel() * t.element_size()
            if name in routed:
                tally["expert_gathered"] += t.numel() * t.element_size()
        return t

    def spy_sfwd(ctx, dim, devices, x):
        tally["scatter_calls"] += 1
        return sfwd(ctx, dim, devices, x)

    def moved(ts):
        if ts[0].dim() == 5:
            m = len(ts)
            tally["exchange"] += sum(t.numel() * t.element_size()
                                     for t in ts) * (m - 1) // m
            tally["exchange_calls"] += 1

    def spy_fwd(ctx, split_dim, cat_dim, pieces, *xs):
        moved(xs)
        if xs[0].dim() == 4:        # the serving prefill's cache relayout
            tally["relayout"] += sum(
                x.narrow(split_dim, *pieces[j]).numel() * x.element_size()
                for i, x in enumerate(xs) for j in range(len(xs)) if i != j)
        return fwd(ctx, split_dim, cat_dim, pieces, *xs)

    def spy_bwd(ctx, *gs):
        moved(gs)
        return bwd(ctx, *gs)

    def spy_bfwd(ctx, devices, x):
        if x.shape[-1] == k:
            tally["route"] += x.numel() * x.element_size() * (
                len(devices) - 1)
        return bfwd(ctx, devices, x)

    def spy_bbwd(ctx, *gs):
        if gs[0].shape[-1] == k:
            tally["route"] += sum(g.numel() * g.element_size()
                                  for g in gs[1:])
        return bbwd(ctx, *gs)

    tp.GridView.chunk = spy_chunk
    tp._AllToAll.forward = staticmethod(spy_fwd)
    tp._AllToAll.backward = staticmethod(spy_bwd)
    tp._Broadcast.forward = staticmethod(spy_bfwd)
    tp._Broadcast.backward = staticmethod(spy_bbwd)
    tp._Scatter.forward = staticmethod(spy_sfwd)
    try:
        yield tally
    finally:
        tp.GridView.chunk = chunk
        tp._AllToAll.forward = staticmethod(fwd)
        tp._AllToAll.backward = staticmethod(bwd)
        tp._Broadcast.forward = staticmethod(bfwd)
        tp._Broadcast.backward = staticmethod(bbwd)
        tp._Scatter.forward = staticmethod(sfwd)


def exchange_bytes(cfg, B: int, T: int, m: int, passes: int = 3) -> int:
    """The MoE exchange's bytes a step, from the shapes: each layer, in the
    forward, the recompute and the backward, every position hands each
    other position its ``[B, T/m, k, d]`` contributions (model dtype)."""
    import torch

    from repro_torch.models import transformer as tf

    item = torch.empty((), dtype=tf.DTYPES[cfg.dtype]).element_size()
    return (passes * cfg.n_layers * (m - 1) * B * T * cfg.moe.top_k
            * cfg.d_model * item)


def route_bytes(cfg, B: int, T: int, m: int) -> int:
    """The routing broadcast's bytes a step, from the shapes: each layer,
    in the forward and the recompute, position 0 hands each other position
    every token's ``top_k`` expert ids (int64) and gates (f32); in the
    backward each other position hands back the gates' gradients (f32)."""
    return cfg.n_layers * (m - 1) * B * T * cfg.moe.top_k * (2 * (8 + 4)
                                                             + 4)


def gathered_before(cfg, n_micro: int, m: int = 2) -> int:
    """The routed expert bytes the parent's layout gathered a step onto
    position 0 (every other position's chunk of each routed leaf, in the
    forward and the recompute of each call)."""
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    return n_micro * cfg.n_layers * 2 * (m - 1) * (3 * e * d * f * 2) // m


def fold_reads(lm, reads, grads, prefix: str, device) -> dict:
    """``{leaf under prefix: its gradient}`` from a grid's reads
    (``GridView.reads``) and their gradients: each chunk's partials folded
    in position order on ``device``, the chunks joined along the model
    split."""
    import torch

    from repro_torch.launch import tp

    parts: dict = {}
    for (j, key, _), g in sorted(zip(reads, grads), key=lambda r: r[0][0]):
        if g is not None:
            parts.setdefault(key, []).append(g)
    out = {}
    for name in sorted({k[0] for k in parts}):
        keys = sorted((k for k in parts if k[0] == name),
                      key=lambda k: -1 if k[2] is None else k[2])
        chunks = [tp.fold(parts[k], device) for k in keys]
        md = lm.mdims[name]
        out[name[len(prefix):]] = (chunks[0] if md is None
                                   else torch.cat(chunks, md))
    return out


def tp_moe_layer(card: str) -> None:
    """(h)'s layer check: one DeepSeek-MoE-16B layer at full width in bf16
    over ``(data 1, model 2)`` on ``cuda:0`` (``tp.moe_routed`` /
    ``tp.moe_block``) against ``moe.apply_moe`` on the same whole rows, B
    TP_MOE_LAYER_B x T TP_MOE_LAYER_T: the routed output, the aux loss and
    each routed expert leaf's and the router's gradient bit-equal (position
    0 routes, as ``apply_moe`` does on its one device); the whole layer's
    output gap (the shared expert's row-parallel partial sums) and its
    leaves' gradients printed."""
    import torch

    from repro_torch.launch import fsdp, tp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    cfg = moe_config(1)
    cuda0 = torch.device("cuda", 0)
    prefix = "blocks.0.moe."
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    lm = fsdp.shard(model, tmesh.LogicalMesh((1, 2), ("data", "model"),
                                             "cuda:0"),
                    groups=[((cuda0, cuda0), range(0, 1))])
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (TP_MOE_LAYER_B, TP_MOE_LAYER_T, cfg.d_model)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    cot = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    out = {}
    for tag, fn in (("routed", tp.moe_routed), ("whole", tp.moe_block)):
        p = {n[len(prefix):]: t.detach().clone().requires_grad_(True)
             for n, t in model.named_parameters() if n.startswith(prefix)}
        if tag == "routed":
            p = {n: t for n, t in p.items() if not n.startswith("shared_")}
        ref = moe_mod.apply_moe(p, x, cfg.moe)
        g_ref = dict(zip(p, torch.autograd.grad(
            (ref.y.float() * cot.float()).sum() + ref.aux_loss,
            list(p.values()))))
        view = tp.GridView(lm, 0)
        st = tp.Stream(view.devices, TP_MOE_LAYER_T)
        with torch.enable_grad():
            ys, aux = fn(view, prefix, cfg, st, [x.clone(), x.clone()])
            loss = sum((y.float() * c.float()).sum()
                       for y, c in zip(ys, cot.chunk(2, 1))) + aux
            reads = [r for r in view.reads if r[1][0].startswith(prefix)]
            grads = torch.autograd.grad(loss, [a for _, _, a in reads],
                                        allow_unused=True)
        g_tp = fold_reads(lm, reads, grads, prefix, cuda0)
        y = torch.cat(ys, 1)
        out[tag] = {
            "y": bits_equal(y, ref.y), "aux": bits_equal(aux, ref.aux_loss),
            "y_gap": (y.float() - ref.y.float()).abs().max().item(),
            "grads": {n: bits_equal(g_tp[n], g_ref[n]) for n in g_ref}}
        del p, ref, g_ref, g_tp, grads, reads, ys, view
    print(f"[train] (h) layer on {card}: {cfg.name} layer 0 at full width, "
          f"bf16, (data 1, model 2) on cuda:0, B={TP_MOE_LAYER_B} "
          f"T={TP_MOE_LAYER_T}, against moe.apply_moe on the same rows: "
          f"routed y bit-equal {out['routed']['y']}, aux "
          f"{out['routed']['aux']}, routed expert and router gradients "
          f"bit-equal {out['routed']['grads']}; with the shared "
          f"expert: y max |diff| {out['whole']['y_gap']:.3e} (bit-equal "
          f"{out['whole']['y']}), aux {out['whole']['aux']}, gradients "
          f"bit-equal {out['whole']['grads']}", flush=True)
    check(out["routed"]["y"] and out["routed"]["aux"]
          and all(out["routed"]["grads"].values())
          and out["whole"]["aux"]
          and all(out["whole"]["grads"][n] for n in ROUTED + ("router",)),
          f"(h) the tensor-parallel MoE layer differs from apply_moe: "
          f"{out}")
    del lm, model, x, cot
    gc.collect()
    torch.cuda.empty_cache()


def train_tp_moe(card: str) -> None:
    """(h) DeepSeek-MoE-16B at full width, TP_MOE_LAYERS layers, bf16, seed
    0, B TRAIN_B x T TRAIN_T at the dry run's n_micro, over ``(data 1,
    model 2)`` with both positions on ``cuda:0`` (``launch/tp.py``: each
    position runs its own experts; an all-to-all hands the expert outputs
    back to the sequence slices): the bytes placed against
    ``param_specs``' prediction, the routed expert bytes gathered (0), the
    exchange's bytes against :func:`exchange_bytes` and the routing
    broadcast's against :func:`route_bytes`; one step against
    the one-card step (TP_MOE_LOSS_TOL, TP_MOE_PARAM_TOL, at most
    TP_MOE_MOVED_SHARE apart); two steps from one state bit-equal; step
    ms, tokens/s, the step's own peak (<= TP_PEAK_GIB)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    tp_moe_layer(card)
    cfg = moe_config()
    cuda0 = torch.device("cuda", 0)
    grid_ = [((cuda0, cuda0), range(0, 1))]
    mesh = tmesh.LogicalMesh((1, 2), ("data", "model"), "cuda:0")
    n_micro = ttrain.micro_batches(tf.param_count(tf.init_params(
        configs.get("deepseek_moe_16b"), device="meta")))
    batch = lm_batch(cfg, TRAIN_B, TRAIN_T, 0, "cuda")

    def draw():
        return tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))

    def tp_step():
        lm, (placed, _) = placed_bytes(
            lambda: fsdp.shard(draw(), mesh, groups=grid_))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        with tp_traffic(lm) as tally:
            t0 = time.perf_counter()
            loss = ttrain.make_dense_train_step(
                cfg, lr=TRAIN_LR, n_micro=n_micro)(lm, batch)[1]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return lm, {"ms": ms, "loss": loss, "placed": placed,
                    "launches": ops.launch_counts(), **tally,
                    "peak": torch.cuda.max_memory_allocated() - held
                    + placed}

    gc.collect()
    torch.cuda.empty_cache()
    model = draw()          # the one-card step, kept for the comparison
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_1 = ttrain.make_dense_train_step(cfg, lr=TRAIN_LR,
                                          n_micro=n_micro)(model, batch)[1]
    torch.cuda.synchronize()
    ms_1 = (time.perf_counter() - t0) * 1e3
    peak_1 = torch.cuda.max_memory_allocated()
    lm, a = tp_step()
    kept = {n: lm.full(n, cuda0) for n in lm.shapes}
    err, moved, total, worst = gap_on_card(kept, dict(
        model.named_parameters()))
    del lm, model
    gc.collect()
    lm, b = tp_step()
    same = bits_equal(a["loss"], b["loss"]) and all(
        bits_equal(lm.full(n, cuda0), p) for n, p in kept.items())
    del lm, kept
    predicted = grid_bytes_on(cfg, mesh, grid_, cuda0)
    want_x = exchange_bytes(cfg, TRAIN_B, TRAIN_T, 2)
    want_r = route_bytes(cfg, TRAIN_B, TRAIN_T, 2)
    before = gathered_before(cfg, n_micro)
    loss_err = abs(a["loss"].item() - loss_1.item())
    tokens = TRAIN_B * TRAIN_T
    print(f"[train] (h) tensor parallel MoE on {card}: {cfg.name} at full "
          f"width, {cfg.n_layers} of 28 layers, bf16, B={TRAIN_B} "
          f"T={TRAIN_T} as n_micro={n_micro}, (data 1, model 2) with both "
          f"positions on cuda:0: cuda:0 holds {a['placed']} bytes after "
          f"placement, param_specs predict {predicted}; routed expert bytes "
          f"gathered {a['expert_gathered']} / {b['expert_gathered']} "
          f"(the parent's layout: {before}); exchange {a['exchange']} / "
          f"{b['exchange']} bytes in {a['exchange_calls']} calls (hand "
          f"count {want_x}); routing broadcast {a['route']} / "
          f"{b['route']} bytes (hand count {want_r}); steps "
          f"{a['ms']:.3f} / {b['ms']:.3f} ms "
          f"({tokens / a['ms'] * 1e3:.1f} / {tokens / b['ms'] * 1e3:.1f} "
          f"tokens/s; the one-card step {ms_1:.3f} ms, peak "
          f"{peak_1 / 2**30:.2f} GiB), peak {a['peak'] / 2**30:.2f} / "
          f"{b['peak'] / 2**30:.2f} GiB; against the one-card step: loss "
          f"{a['loss'].item():.6f} vs {loss_1.item():.6f} |diff| "
          f"{loss_err:.3e} (tolerance {TP_MOE_LOSS_TOL}), params max |diff| "
          f"{err:.3e} at {worst} (tolerance {TP_MOE_PARAM_TOL}), {moved} of "
          f"{total} elements apart (share tolerance {TP_MOE_MOVED_SHARE}); "
          f"two steps from one state bit-equal {same}; launches "
          f"{a['launches']}", flush=True)
    check(a["placed"] == predicted and b["placed"] == predicted,
          f"(h) cuda:0 holds {a['placed']} / {b['placed']} bytes after "
          f"placement, param_specs predict {predicted}")
    check(a["expert_gathered"] == 0 and b["expert_gathered"] == 0,
          f"(h) routed expert bytes gathered: {a['expert_gathered']}")
    check(a["exchange"] == want_x and b["exchange"] == want_x,
          f"(h) exchange {a['exchange']} bytes, hand count {want_x}")
    check(a["route"] == want_r and b["route"] == want_r,
          f"(h) routing broadcast {a['route']} bytes, hand count {want_r}")
    check(same, "(h) two tensor-parallel steps from one state differ")
    check(math.isfinite(a["loss"].item()), "(h) a non-finite loss")
    check(loss_err <= TP_MOE_LOSS_TOL, f"(h) loss {loss_err:.3e}")
    check(err <= TP_MOE_PARAM_TOL and moved <= TP_MOE_MOVED_SHARE * total,
          f"(h) params {err:.3e} at {worst}, {moved} of {total} apart")
    check(max(a["peak"], b["peak"]) <= TP_PEAK_GIB * 2**30,
          f"(h) peaked at {max(a['peak'], b['peak']) / 2**30:.2f} GiB")
    check(a["launches"]["flash_attention"] == 0, "(h) launched flash")
    del batch
    gc.collect()
    torch.cuda.empty_cache()


# (i) Zamba2-7B at full width, 9 of 81 layers (one super-block: 9 Mamba2
# mixers and the shared attention block), bf16, B 2 x T 4096 at n_micro 1,
# and (j) xLSTM-125M at full width, 2 of 12 layers (an sLSTM and an
# mLSTM), bf16, B 2 x T 512, each over (data 1, model 2) on cuda:0 against
# the one-card step (launch/tp.py's head-split mixer and cells): the loss,
# the params after one step (max |diff| and the share of elements apart),
# as (f) and (h).
# About 2x the readings on an H100 80GB HBM3 at 700 W: (i) 2.356e-04;
# 1.221e-04 at embed (one bf16 ulp of values in [1/64, 1/32));
# 4,828,352 of 1,136,645,712 elements apart (4.25e-3: the updates that
# round to a neighbouring bf16 value, many at a loss of 11.1); (j)
# 2.975e-04; 1.221e-04 at embed; 4,258 of 52,802,304 (8.1e-5)
TP_SSM_LAYERS = 9
TP_SSM_B, TP_SSM_T = 2, 4096
TP_SSM_LOSS_TOL = 5e-4
TP_SSM_PARAM_TOL = 2.5e-4
TP_SSM_MOVED_SHARE = 8.5e-3
TP_XLSTM_LAYERS = 2
TP_XLSTM_B, TP_XLSTM_T = 2, 512
TP_XLSTM_LOSS_TOL = 6e-4
TP_XLSTM_PARAM_TOL = 2.5e-4
TP_XLSTM_MOVED_SHARE = 1.6e-4
# the layer checks (one mixer, each cell at full width, B 2 x T 256):
# against the one-device block on the same rows on the card, the output's
# max |diff| over its max |y| and each gradient's (the input's and every
# leaf's) over its max |g|, in f32 (TF32 off) and bf16. About 2x the
# readings on the same card: f32 2.341e-07 (the mLSTM's output), 3.905e-05
# (the mixer's A_log); bf16 3.067e-03 (the mLSTM's output: a bf16 ulp at
# 1/2 of max |y|), 5.988e-03 (the sLSTM's input gradient)
TP_LAYER_B, TP_LAYER_T = 2, 256
TP_LAYER_TOL = {"float32": (5e-7, 8e-5), "bfloat16": (6.2e-3, 1.2e-2)}


def ssm_across(layers: int) -> tuple[int, int]:
    """Zamba2-7B's mixers at model 2, by hand: (the weight bytes the
    positions read of each other's chunks a step, the bytes the parent's
    ``on_lead`` gathered onto position 0). ``in_proj`` is [3584, 14576]
    (z 0-7168, x 7168-14336, B 14336-14400, C 14400-14464, dt 14464-14576)
    in chunks of 7288 columns: position 0 (heads 0-55) reads of chunk 1 its
    x 7288-10752, B, C and its dt 14464-14520 (3464 + 128 + 56 = 3648
    columns), position 1 (heads 56-111) of chunk 0 its z 3584-7168 (3584
    columns); ``conv_w`` [4, 7296] in chunks of 3648: B and C (128
    channels) of chunk 1, x 3584-3648 (64) of chunk 0; bf16. ``out_proj``,
    ``A_log``, ``D``, ``dt_bias`` fall on the heads. The parent gathered
    chunk 1 of ``in_proj`` (7288 columns), ``out_proj`` (3584 rows),
    ``conv_w`` (3648 channels) and ``A_log`` / ``D`` / ``dt_bias`` (56 f32
    each). A mixer runs three times a step: the forward, the super-block's
    recompute and its own."""
    now = (3648 + 3584) * 3584 * 2 + (128 + 64) * 4 * 2
    before = (7288 * 3584 + 3584 * 3584 + 4 * 3648) * 2 + 3 * 56 * 4
    return 3 * layers * now, 3 * layers * before


def xlstm_across() -> tuple[int, int]:
    """xLSTM-125M's two cells at model 2, by hand, as :func:`ssm_across`
    (a cell runs once a step: no checkpoint). d 768, 4 heads of 384,
    bf16. sLSTM: ``w_in`` [768, 6144] holds gates z and i in chunk 0, f
    and o in chunk 1, so each position reads the other chunk's two gates of
    its two heads (1536 columns); ``r`` [4, 384, 1536] splits along dh,
    so each reads the other half of its heads' rows ([2, 192, 1536]).
    mLSTM: ``w_qkv`` [768, 4608] in chunks of 2304 holds q and k of heads
    0-1 in chunk 0: position 0 reads its v (768 columns) of chunk 1,
    position 1 its q of chunk 0. The parent gathered chunk 1 of ``w_in``,
    ``r``, ``w_out`` and ``w_qkv``, ``w_o``, ``w_out``."""
    now = 2 * (1536 * 768 + 2 * 192 * 1536) * 2 + 2 * 768 * 768 * 2
    before = ((768 * 3072 + 4 * 192 * 1536 + 768 * 768)
              + (768 * 2304 + 768 * 768 + 768 * 768)) * 2
    return now, before


def ssm_config(layers: int = TP_SSM_LAYERS, **over):
    """Zamba2-7B at its published widths, ``layers`` deep (one shared
    block every 9 mixers)."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get("zamba2_7b"), n_layers=layers,
                               **over)


def xlstm_config(layers: int = TP_XLSTM_LAYERS, **over):
    """xLSTM-125M at its published widths, ``layers`` deep."""
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get("xlstm_125m"), n_layers=layers,
                               **over)


def tp_block_layer(card: str, tag: str, cfg, prefix: str) -> None:
    """A layer check: the block under ``prefix`` (a Mamba2 mixer, an sLSTM
    or an mLSTM cell) of ``cfg`` at full width over ``(data 1, model 2)``
    on ``cuda:0`` (``tp.ssm_mixer`` / ``tp.xlstm_cell``) against the
    one-device block (``x + ssd_forward(norm(x))``, ``x +
    slstm_forward(x)``, ``x + mlstm_forward(x)``) on the same rows, B
    TP_LAYER_B x T TP_LAYER_T, in f32 (TF32 off) and bf16: the output, the
    input's gradient and every leaf's gradient within TP_LAYER_TOL."""
    import dataclasses

    import torch

    from repro_torch.launch import fsdp, tp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.layers import apply_norm

    cuda0 = torch.device("cuda", 0)
    mesh = tmesh.LogicalMesh((1, 2), ("data", "model"), "cuda:0")
    if prefix.startswith("ssm_blocks."):
        def one(c):
            return lambda p, x: x + ssm_mod.ssd_forward(
                p["ssm"], apply_norm(p["norm"], x, c.norm), c.ssm)[0]
        grid_fn = tp.ssm_mixer
    else:
        def one(c):
            run = (xlstm_mod.slstm_forward if prefix.startswith("slstm.")
                   else xlstm_mod.mlstm_forward)
            return lambda p, x: x + run(p, x, c.n_heads)[0]
        grid_fn = tp.xlstm_cell
    tf32 = torch.backends.cuda.matmul.allow_tf32
    lines, fails = [], []
    for dtype, (y_tol, g_tol) in TP_LAYER_TOL.items():
        torch.backends.cuda.matmul.allow_tf32 = False
        c = dataclasses.replace(cfg, dtype=dtype)
        model = tf.init_params(c, torch.Generator(device="cuda").manual_seed(0))
        lm = fsdp.shard(model, mesh, groups=[((cuda0, cuda0), range(0, 1))])
        gen = torch.Generator(device="cuda").manual_seed(1)
        shape = (TP_LAYER_B, TP_LAYER_T, c.d_model)
        x = torch.randn(shape, generator=gen, device="cuda").to(
            tf.DTYPES[dtype])
        cot = torch.randn(shape, generator=gen, device="cuda")
        p = {n[len(prefix):]: t.detach().clone().requires_grad_(True)
             for n, t in model.named_parameters() if n.startswith(prefix)}
        xx = x.clone().requires_grad_(True)
        with torch.enable_grad():
            y_ref = one(c)(tp.nested(p, "", p.get), xx)
            g_ref = torch.autograd.grad((y_ref.float() * cot).sum(),
                                        [xx, *p.values()])
        g_ref = {"x": g_ref[0], **dict(zip(p, g_ref[1:]))}
        view = tp.GridView(lm, 0)
        st = tp.Stream(view.devices, TP_LAYER_T)
        xs = [t.clone().requires_grad_(True) for t in st.inputs(x)]
        with torch.enable_grad():
            ys = grid_fn(view, prefix, c, st, xs)
            loss = sum((y.float() * ct).sum()
                       for y, ct in zip(ys, cot.chunk(2, 1)))
            reads = [r for r in view.reads if r[1][0].startswith(prefix)]
            grads = torch.autograd.grad(loss, xs + [a for _, _, a in reads],
                                        allow_unused=True)
        g_tp = {"x": torch.cat(grads[:2], 1),
                **fold_reads(lm, reads, grads[2:], prefix, cuda0)}
        y = torch.cat(ys, 1)

        def rel(a, b):
            return ((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30)).item()

        y_gap = rel(y, y_ref)
        gaps = {n: rel(g_tp[n], g_ref[n]) for n in g_ref}
        worst = max(gaps, key=gaps.get)
        lines.append(f"{dtype}: y {y_gap:.3e} (tolerance {y_tol}), "
                     f"gradients {gaps[worst]:.3e} at {worst} (tolerance "
                     f"{g_tol}; x {gaps['x']:.3e})")
        if y_gap > y_tol or gaps[worst] > g_tol or sorted(g_tp) != sorted(
                g_ref):
            fails.append(lines[-1])
        del model, lm, p, g_ref, g_tp, grads, reads, ys, view, xs, x, cot
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"[train] {tag} layer on {card}: {cfg.name} {prefix[:-1]} at full "
          f"width, (data 1, model 2) on cuda:0, B={TP_LAYER_B} "
          f"T={TP_LAYER_T}, against the one-device block on the same rows, "
          f"max |diff| over max |ref|: " + "; ".join(lines), flush=True)
    check(not fails, f"{tag} the head-split {prefix[:-1]} differs from the "
          f"one-device block: {fails}")


def train_tp_heads(card: str, tag: str, cfg, B: int, T: int, tols,
                   across: tuple[int, int], n_micro: int = 1,
                   warm: bool = True) -> None:
    """(f), (i), (j): ``cfg`` in bf16, seed 0, B x T at ``n_micro``, over
    ``(data 1, model 2)`` with both positions on ``cuda:0`` (``launch/
    tp.py``: each position runs its own heads): the bytes placed against
    ``param_specs``' prediction, the weight bytes read across positions
    against the hand count ``across[0]`` (before head-split SSM and xLSTM
    blocks: ``across[1]``), no scatter of a whole output from position 0;
    one step against the one-card step (``tols``: loss, params, share
    apart; after an unmeasured one-card step where ``warm``); two steps
    from one state bit-equal; step ms, tokens/s, the step's own peak (<=
    TP_PEAK_GIB)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp, tp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    loss_tol, param_tol, share = tols
    cuda0 = torch.device("cuda", 0)
    grid_ = [((cuda0, cuda0), range(0, 1))]
    mesh = tmesh.LogicalMesh((1, 2), ("data", "model"), "cuda:0")
    batch = lm_batch(cfg, B, T, 0, "cuda")

    def draw():
        return tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))

    def tp_step():
        lm, (placed, _) = placed_bytes(
            lambda: fsdp.shard(draw(), mesh, groups=grid_))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        with tp_traffic(lm) as tally:
            t0 = time.perf_counter()
            loss = ttrain.make_dense_train_step(
                cfg, lr=TRAIN_LR, n_micro=n_micro)(lm, batch)[1]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return lm, {"ms": ms, "loss": loss, "placed": placed,
                    "launches": ops.launch_counts(), **tally,
                    "peak": torch.cuda.max_memory_allocated() - held
                    + placed}

    gc.collect()
    torch.cuda.empty_cache()
    step = ttrain.make_dense_train_step(cfg, lr=TRAIN_LR, n_micro=n_micro)
    if warm:    # Zamba2-7B's first one-card step in a process took 9.3 s,
        step(draw(), batch)     # the next 0.78 s (NVIDIA H100 80GB HBM3,
        gc.collect()            # 700 W)
    model = draw()          # the one-card step, kept for the comparison
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_1 = step(model, batch)[1]
    torch.cuda.synchronize()
    ms_1 = (time.perf_counter() - t0) * 1e3
    peak_1 = torch.cuda.max_memory_allocated()
    lm, a = tp_step()
    kept = {n: lm.full(n, cuda0) for n in lm.shapes}
    want = dict(model.named_parameters())
    err, moved, total, worst = gap_on_card(kept, want)
    most = apart_by_leaf(kept, want)
    del lm, model, want
    gc.collect()
    lm, b = tp_step()
    same = bits_equal(a["loss"], b["loss"]) and all(
        bits_equal(lm.full(n, cuda0), p) for n, p in kept.items())
    del lm, kept
    predicted = grid_bytes_on(cfg, mesh, grid_, cuda0)
    loss_err = abs(a["loss"].item() - loss_1.item())
    tokens = B * T
    print(f"[train] {tag} tensor parallel on {card}: {cfg.name} at full "
          f"width, {cfg.n_layers} layers, bf16, B={B} T={T} as "
          f"n_micro={n_micro}, (data 1, model 2) with both positions on "
          f"cuda:0: cuda:0 holds {a['placed']} bytes after placement, "
          f"param_specs predict {predicted}; weight bytes read across "
          f"positions {a['across']} / {b['across']} (hand count "
          f"{across[0]}; on_lead gathered {across[1]}), scatters from position 0 "
          f"{a['scatter_calls']}; steps {a['ms']:.3f} / {b['ms']:.3f} ms "
          f"({tokens / a['ms'] * 1e3:.1f} / {tokens / b['ms'] * 1e3:.1f} "
          f"tokens/s; the one-card step {ms_1:.3f} ms, peak "
          f"{peak_1 / 2**30:.2f} GiB), peak {a['peak'] / 2**30:.2f} / "
          f"{b['peak'] / 2**30:.2f} GiB; against the one-card step: loss "
          f"{a['loss'].item():.6f} vs {loss_1.item():.6f} |diff| "
          f"{loss_err:.3e} (tolerance {loss_tol}), params max |diff| "
          f"{err:.3e} at {worst} (tolerance {param_tol}), {moved} of "
          f"{total} elements apart (share tolerance {share}; most in "
          f"{most}); two steps from one state bit-equal {same}; launches "
          f"{a['launches']}", flush=True)
    check(a["placed"] == predicted and b["placed"] == predicted,
          f"{tag} cuda:0 holds {a['placed']} / {b['placed']} bytes after "
          f"placement, param_specs predict {predicted}")
    check(a["across"] == across[0] and b["across"] == across[0],
          f"{tag} weight bytes read across positions {a['across']} / "
          f"{b['across']}, hand count {across[0]}")
    check(not hasattr(tp, "on_lead") and a["scatter_calls"] == 0,
          f"{tag} a block still runs on position 0 alone "
          f"({a['scatter_calls']} scatters)")
    check(same, f"{tag} two tensor-parallel steps from one state differ")
    check(math.isfinite(a["loss"].item()), f"{tag} a non-finite loss")
    check(loss_err <= loss_tol, f"{tag} loss {loss_err:.3e}")
    check(err <= param_tol and moved <= share * total,
          f"{tag} params {err:.3e} at {worst}, {moved} of {total} apart")
    check(max(a["peak"], b["peak"]) <= TP_PEAK_GIB * 2**30,
          f"{tag} peaked at {max(a['peak'], b['peak']) / 2**30:.2f} GiB")
    check(a["launches"]["flash_attention"] == 0, f"{tag} launched flash")
    del batch
    gc.collect()
    torch.cuda.empty_cache()


def train_tp_ssm(card: str) -> None:
    """(i) Zamba2-7B (its layer check first: one mixer) and (j)
    xLSTM-125M (a layer check of each cell first), head-split over
    ``(data 1, model 2)`` (:func:`train_tp_heads`)."""
    tp_block_layer(card, "(i)", ssm_config(1, shared_attn_every=1),
                   "ssm_blocks.0.0.")
    train_tp_heads(card, "(i)", ssm_config(), TP_SSM_B, TP_SSM_T,
                   (TP_SSM_LOSS_TOL, TP_SSM_PARAM_TOL, TP_SSM_MOVED_SHARE),
                   ssm_across(TP_SSM_LAYERS))
    for prefix in ("slstm.0.", "mlstm.0."):
        tp_block_layer(card, "(j)", xlstm_config(), prefix)
    train_tp_heads(card, "(j)", xlstm_config(), TP_XLSTM_B, TP_XLSTM_T,
                   (TP_XLSTM_LOSS_TOL, TP_XLSTM_PARAM_TOL,
                    TP_XLSTM_MOVED_SHARE), xlstm_across())


def train_flops(cfg, n_params: int, B: int, T: int) -> dict:
    """A step's floating-point operations, as ``FlopCounterMode`` counts
    the step on the meta device (``launch/dryrun.py``; held within 1% by
    ``tests/test_torch_dryrun.py``): 6 N tokens, N every parameter but the
    embedding table (a gather, no product); the block checkpoints' second
    forward of every block product but the MLP's ``wo``, whose output no
    backward needs (the recompute stops at the last saved input), and the
    head's (2 per parameter a token); and ``attend``'s score and PV
    products over the full [T, T] square it computes before masking: a
    forward, its recompute and a backward of twice the forward, 4 forward
    squares, and half a square more where ``attend_chunked`` splits T into
    query chunks under checkpoints of their own."""
    from repro_torch.models.attention import CHUNK_Q

    tokens = B * T
    embed = cfg.vocab * cfg.d_model
    outside = embed + cfg.d_model                            # embed, norm
    mlp_wo = cfg.d_ff * cfg.d_model * cfg.n_layers
    attn_fwd = 4 * B * T * T * cfg.n_heads * cfg.hd * cfg.n_layers
    out = {"model": 6 * (n_params - embed) * tokens,
           "recompute": 2 * (n_params - outside - mlp_wo) * tokens,
           "attention": (4.5 if T > CHUNK_Q else 4.0) * attn_fwd}
    out["total"] = sum(out.values())
    return out


def train_yi6b(card: str, sharded: dict) -> None:
    """Yi-6B at full width and depth in bf16: TRAIN_STEPS SGD steps on one
    ``train_4k``-length batch of TRAIN_B rows, as the dry run's microbatch
    rule splits it. Step 1 is held against ``sharded``
    (``train_sharded_yi6b``'s two-group step): loss and params bit-equal,
    and its peak at most this run's plus one gathered block and
    ``lm_head``."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    cfg = configs.get("yi_6b")
    B, T = TRAIN_B, TRAIN_T
    gc.collect()        # nothing of the two-group step in the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = tf.param_count(params)
    n_micro = ttrain.micro_batches(n_params)
    batch = lm_batch(cfg, B, T, 0, "cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    watched = ("embed", "lm_head", "final_norm.scale", "blocks.0.attn.wq",
               f"blocks.{cfg.n_layers - 1}.mlp.wo")
    named = dict(params.named_parameters())
    before = {n: named[n].detach().clone() for n in watched}

    # step 1 as the step's two parts, so every gradient leaf can be held
    ops.reset_launch_counts()
    losses, times = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = ttrain.step_gradients(params, cfg, batch, n_micro)
    ttrain.sgd_update(params, grads, TRAIN_LR)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    losses.append(loss.item())
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in grads.items() if not bool(g.any())]
    del grads
    same = {"loss": bits_equal(loss.cpu(), sharded["loss"]),
            "params": all(bits_equal(p, sharded["params"][n].to(p.device))
                          for n, p in params.named_parameters())}
    sharded["params"] = None
    step = ttrain.make_dense_train_step(cfg, lr=TRAIN_LR, n_micro=n_micro)
    for _ in range(TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = step(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # one more step, profiled: its loss is the loss after TRAIN_STEPS steps
    out = {}
    prof = profiled(lambda: out.update(loss=step(params, batch)[1]), top=8,
                    name_len=160)
    losses.append(out["loss"].item())
    counts = ops.launch_counts()
    moved = {n: int((named[n] != before[n]).sum()) for n in watched}
    step_ms = statistics.median(times[1:])
    flops = train_flops(cfg, n_params, B, T)
    bound_ms = flops["total"] / BF16_FLOPS * 1e3
    print(f"[train] {cfg.name} on {card}: {cfg.n_layers} layers d_model "
          f"{cfg.d_model} bf16, {n_params} parameters drawn in "
          f"{draw_s:.1f} s; B={B} T={T} as n_micro={n_micro} "
          f"(micro_batches), lr {TRAIN_LR}: losses {losses} (steps "
          f"1-{TRAIN_STEPS}, then the profiled step {TRAIN_STEPS + 1}); step "
          f"ms {[round(t, 3) for t in times]}, median of steps 2-"
          f"{TRAIN_STEPS} {step_ms:.3f} ms ({B * T / step_ms * 1e3:.1f} "
          f"tokens/s), peak memory {peak_gib:.2f} GiB; flops a step "
          f"{flops['total']:.4e} (6NT {flops['model']:.4e} + remat "
          f"{flops['recompute']:.4e} + attention {flops['attention']:.4e}) "
          f"= {bound_ms:.1f} ms at {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{bound_ms / step_ms:.1%} of it reached; launches {counts}; "
          f"elements moved after {TRAIN_STEPS + 1} steps: {moved}",
          flush=True)
    print(f"[train] {cfg.name} profiled step on {card}: wall "
          f"{prof['wall_ms']:.3f} ms, {prof['kernels']} kernels, device "
          f"{prof['device_ms']:.3f} ms (busy {prof['busy']:.1%}); top: "
          + "; ".join(f"{k} x{c} {t:.3f} ms" for k, c, t in prof["top"]),
          flush=True)
    allowed = peak_gib * 2**30 + sharded["block"] + sharded["head"]
    print(f"[train] {cfg.name} over two groups on cuda:0 against step 1 "
          f"(n_micro {n_micro}) on {card}: bit-equal {same}; its step "
          f"{sharded['ms']:.3f} ms against step 1's {times[0]:.3f} ms; its "
          f"peak {sharded['peak'] / 2**30:.2f} GiB against {peak_gib:.2f} "
          f"GiB + a gathered block + lm_head = {allowed / 2**30:.2f} GiB",
          flush=True)
    check(all(same.values()), f"the two-group step differs from the "
          f"n_micro {n_micro} step: {same}")
    check(sharded["peak"] <= allowed, f"the two-group step's peak "
          f"{sharded['peak'] / 2**30:.2f} GiB above {allowed / 2**30:.2f}")
    check(counts["flash_attention"] == 0, "training launched flash")
    check(not bad, f"non-finite gradients: {bad}")
    check(not zero, f"all-zero gradients: {zero}")
    check(all(map(math.isfinite, losses)), f"a non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall over "
          f"{TRAIN_STEPS} steps: {losses}")
    del params, before, batch, out
    gc.collect()
    torch.cuda.empty_cache()


def moe_idle_experts(cfg, grads: dict) -> str:
    """Per MoE layer, the experts whose whole gradient is zero: no kept
    assignment reached them."""
    idle = {}
    for i in range(cfg.n_layers):
        g = grads.get(f"blocks.{i}.moe.wo")
        if g is not None:
            ids = (g.flatten(1).abs().amax(1) == 0).nonzero().flatten()
            if ids.numel():
                idle[i] = ids.tolist()
    return f"experts with no gradient (no kept assignment): {idle or 'none'}"


def train_family(arch: str, layers, B: int, card: str) -> None:
    """One config of phase 16 at full width, bf16, one SGD step at T =
    TRAIN_FAMILY_T (TRAIN_XLSTM_T for xLSTM; one batch: the f32
    accumulator of the microbatch rule would not fit beside the VLM's
    weights and gradients), then a second step timed."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    full = configs.get(arch)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t_cell = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    T = TRAIN_XLSTM_T if cfg.xlstm else TRAIN_FAMILY_T
    batch = lm_batch(cfg, B, T, 1, "cuda")
    ops.reset_launch_counts()
    loss, grads = ttrain.step_gradients(params, cfg, batch)
    ttrain.sgd_update(params, grads, TRAIN_LR)
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in grads.items() if not bool(g.any())]
    idle = moe_idle_experts(cfg, grads) if cfg.family == "moe" else ""
    del grads
    step = ttrain.make_dense_train_step(cfg, lr=TRAIN_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss2 = step(params, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    flash = ops.launch_counts()["flash_attention"]
    print(f"[train] {cfg.name} on {card}: {cfg.n_layers} of {full.n_layers} "
          f"layers at full width, bf16, B={B} T={T}: losses "
          f"{loss.item():.6f} then {loss2.item():.6f}; second step "
          f"{step_ms:.3f} ms, peak memory {peak_gib:.2f} GiB; flash "
          f"launches {flash}; leaves with a non-finite gradient "
          f"{bad or 'none'}; all-zero gradient leaves {zero or 'none'}"
          + (f"; {idle}" if idle else "")
          + f"; the cell took {time.perf_counter() - t_cell:.1f} s",
          flush=True)
    check(flash == 0, f"{arch}: training launched flash")
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(loss2)),
          f"{arch}: non-finite loss")
    check(not bad, f"{arch}: non-finite gradients {bad}")
    check(not zero, f"{arch}: all-zero gradient leaves {zero}")
    del params, batch


def train_reduced_parity(arch: str) -> str:
    """The config at ``configs.reduced`` width in f32 (TF32 off): loss and
    every gradient leaf on the card against the CPU."""
    import torch

    from repro_torch import configs
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.reduced(configs.get(arch))
    cpu_model = tf.init_params(cfg, torch.Generator().manual_seed(2))
    model = tf.init_params(cfg, device="cuda")
    model.load_state_dict(cpu_model.state_dict())
    cpu_batch = lm_batch(cfg, 2, 32, 4, "cpu")
    loss, grads = ttrain.value_and_grad(
        model, cfg, {k: v.cuda() for k, v in cpu_batch.items()})
    cpu_loss, cpu_grads = ttrain.value_and_grad(cpu_model, cfg, cpu_batch)
    loss_err = abs(loss.item() - cpu_loss.item())
    rel, at = grad_gap(grads, cpu_grads)
    check(loss_err <= FAMILY_TRAIN_LOSS_TOL and rel <= FAMILY_TRAIN_GRAD_REL,
          f"{arch} reduced, card vs CPU: loss {loss_err:.3e}, gradient {at} "
          f"{rel:.3e} of its max |g|")
    return f"{arch} loss {loss_err:.3e} gradients {rel:.3e} ({at})"


def train_phase(card: str) -> None:
    """Phase 17: LM training on the card. The parity's CPU step runs on a
    worker thread behind (f) to (j) and the families' steps, which copy
    nothing large to the host; the cases with a CPU part run outside that
    window."""
    import torch

    t0 = time.perf_counter()
    train_sharded_parity(card)
    t1 = time.perf_counter()
    train_yi6b(card, train_sharded_yi6b(card))
    t2 = time.perf_counter()
    train_tp_parity(card)
    parity = train_parity(card)
    t3 = time.perf_counter()
    train_tp_steps(card)
    t4 = time.perf_counter()
    for arch, layers, B in FAMILY_CELLS:
        train_family(arch, layers, B, card)
        gc.collect()
        torch.cuda.empty_cache()
    t5 = time.perf_counter()
    parity()
    del parity
    t6 = time.perf_counter()
    lines = [train_reduced_parity(arch) for arch, _, _ in FAMILY_CELLS]
    print(f"[train] families at reduced width, f32 (TF32 off), card vs CPU "
          f"(tolerances {FAMILY_TRAIN_LOSS_TOL} on the loss, "
          f"{FAMILY_TRAIN_GRAD_REL} of each leaf's max |g|): "
          + "; ".join(lines), flush=True)
    print(f"[train] phase 17 took {time.perf_counter() - t0:.1f} s on {card} "
          f"(sharded parity {t1 - t0:.1f} s, Yi-6B {t2 - t1:.1f} s, (g) and "
          f"the parity's card part {t3 - t2:.1f} s, tensor parallel (f) to "
          f"(j) {t4 - t3:.1f} s and families {t5 - t4:.1f} s with the "
          f"parity's CPU step meanwhile, then its wait {t6 - t5:.1f} s)",
          flush=True)


def train_tp_phase(card: str) -> None:
    """[train] (f) to (j): tensor parallelism over ``model``."""
    train_tp_parity(card)
    train_tp_steps(card)


def train_tp_steps(card: str) -> None:
    """[train] (f), (h), (i), (j). (f) Yi-6B whole at the dry run's
    n_micro (:func:`train_tp_heads`): its K/V at model 2 fall on the
    positions' own chunks, so no weight is read across positions."""
    from repro_torch import configs
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    cfg = configs.get("yi_6b")
    train_tp_heads(card, "(f)", cfg, TRAIN_B, TRAIN_T,
                   (TP_LOSS_TOL, TP_PARAM_TOL, TP_MOVED_SHARE), (0, 0),
                   n_micro=ttrain.micro_batches(tf.param_count(
                       tf.init_params(cfg, device="meta"))), warm=False)
    train_tp_moe(card)
    train_tp_ssm(card)


# --------------------------------------------------- phase 18: fl_train
FL_THGS = dict(s0=0.01, alpha=0.9, s_min=0.001)   # the dry run's THGS and
FL_MASK_RATIO = 0.01                               # mask ratio
FL_LR = 0.01                    # make_fl_train_step's defaults: lr 0.01,
FL_B, FL_T = 4, 4096            # server_lr 1; train_4k's T, 2 rows a
FL_STEPS = 1                    # participant (global batch 256 cut to 4);
                                # 3 steps before the tensor-parallel cases,
                                # 2 before the FL encode in place
FL_UNITS = 229                  # Yi-6B's decodes a step on the multi-pod
FL_PARITY_B, FL_PARITY_T = 2, 512      # layout: 7 x 32 slices + 5 leaves
FL_SHARD_T = 128                # (e): one row a group, 2 groups a pod
# (b)'s readings on an H100 80GB HBM3 at 700 W (T 1024): loss 9.537e-07;
# params 2.918e-05 apart at embed, 407,827 of 870,338,560 elements (4.7e-4:
# top-k choices flipped by the gradients' last bits, each a whole update)
FL_LOSS_TOL = 2e-6
FL_PARAM_TOL = 6e-5
FL_MOVED_SHARE = 1e-3
FL_CANCEL_TOL = 1e-4            # tests/test_blocked.py:31-48's rtol / atol
# (f) Yi-6B whole in bf16, each participant over (data 1, model 2) on
# cuda:0, against the one-device step: the params' max |diff| (bf16: an
# update rounded to the neighbouring bf16 value). About 2x the reading on
# an H100 80GB HBM3 at 700 W: 2.441e-04 at embed, 78,324 of 6,061,035,520
# elements apart (1.3e-5, under FL_MOVED_SHARE)
FL_TP_PARAM_TOL = 4.9e-4
FL_PEAK_GIB = 75                # PERF.md section 2's limit of a Yi-6B FL step


def fl_config(layers=None, dtype=None):
    """Yi-6B (cut to ``layers`` in ``dtype`` when given), the multi-pod
    layout on the card (pod 2 x data 16 x model 16: 2 participants of 256
    blocks), the dry run's THGS and mask ratio."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.types import SecureAggConfig, THGSConfig
    from repro_torch.launch import mesh as tmesh

    cfg = configs.get("yi_6b")
    over = {k: v for k, v in (("n_layers", layers), ("dtype", dtype))
            if v is not None}
    cfg = dataclasses.replace(cfg, **over)
    return (cfg, tmesh.make_production_mesh(multi_pod=True, device="cuda"),
            THGSConfig(**FL_THGS), SecureAggConfig(mask_ratio=FL_MASK_RATIO))


def fl_units_check(card: str, device) -> dict:
    """(a) Yi-6B's ``embed`` leaf and ``blocks.mlp.wi_gate``'s slice 0 at
    full width on the multi-pod layout, on shared seeded inputs: each
    participant's keyed masks and blocked encode, and the decode of both,
    bit-equal on the card (the scatter kernel) and the CPU (the plain
    fold); the kernel at the embed decode against its plain version and
    timed. Returns the kernel's row."""
    import torch

    from repro_torch import convert
    from repro_torch.core import threefry
    from repro_torch.core.blocked import (decode_blocked_sum,
                                          encode_leaf_blocked)
    from repro_torch.kernels import ref, stream_decode
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    cfg, mesh, thgs, sa = fl_config()
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", thgs, sa, lr=FL_LR)
    leaves, specs, sizes, leaf_k = step.layout(tf.init_params(cfg,
                                                              device="meta"))
    units = step.units(leaves, specs, sizes, leaf_k)
    paths = [lf.path for lf in leaves]
    picks = [next(u for u in units if u[0] == paths.index("embed")),
             next(u for u in units if u[0] == paths.index(
                 "blocks.mlp.wi_gate") and u[1] is not None and u[1][0] == 0)]
    round_key = threefry.key(0)
    row = None
    for unit in picks:
        lid, sl, nb, kb, km, _ = unit
        shape = leaves[lid].shape if sl is None else sl[2]
        n = int(torch.tensor(shape).prod())
        key = threefry.fold_in(round_key, lid)
        if sl is not None:
            key = threefry.fold_in(key, sl[0])
        # drawn on the card, where a draw of the embed's 262,144,000
        # values takes milliseconds, not seconds
        gen = torch.Generator(device="cuda").manual_seed(lid)
        gs = [(torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(
            torch.bfloat16) for _ in range(2)]
        rs = [(torch.randn(shape, generator=gen, device="cuda") * 1e-4).to(
            torch.bfloat16) for _ in range(2)]
        out = {}
        t_dev = {}
        for dev in (device, torch.device("cpu")):
            t0 = time.perf_counter()
            masks, sts, res = [], [], []
            for p in range(2):
                m = step.masks_for(key, p, n, nb, km, None, dev)
                st, r_new = encode_leaf_blocked(
                    ttrain._neg_lr(gs[p].to(dev), FL_LR), rs[p].to(dev), kb,
                    nb, mask_key=key, k_mask_block=km, n_peers=2, self_id=p,
                    mask_lo=sa.p, mask_q=sa.q, masks=m)
                masks.append(m[:2])
                sts.append(st)
                res.append(r_new)
            idx = torch.stack([st.indices for st in sts])
            vals = torch.stack([st.values for st in sts])
            dense = decode_blocked_sum(idx, vals, n, nb, weight=0.5)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t_dev[dev.type] = time.perf_counter() - t0
            out[dev.type] = (masks, idx, vals, res, dense)
        c, h = out["cuda"], out["cpu"]
        same = {
            "masks": all(bits_equal(a.cpu(), b) for x, y in zip(c[0], h[0])
                         for a, b in zip(x, y)),
            "streams": bits_equal(c[1].cpu(), h[1])
            and bits_equal(c[2].cpu(), h[2]),
            "residuals": all(bits_equal(a.cpu(), b)
                             for a, b in zip(c[3], h[3])),
            "decode": bits_equal(c[4].cpu(), h[4])}
        tag = leaves[lid].path + ("" if sl is None else f"[{sl[0]}]")
        print(f"[fl_train] (a) {tag} {tuple(shape)} on {card}: nb={nb} "
              f"kb={kb} k_mask={km} slots={c[1].numel()} ({c[1].shape[-1]} "
              f"a block row); card vs CPU bit-equal {same}; card "
              f"{t_dev['cuda']:.2f} s, CPU {t_dev['cpu']:.2f} s", flush=True)
        check(all(same.values()), f"{tag}: card vs CPU differ: {same}")
        if sl is None:
            # the kernel at the embed decode against its plain version on
            # the card, and timed (the decode's own weighted flat stream)
            it = c[1].reshape(-1)
            vt = c[2].reshape(-1) * torch.tensor(0.5, device=device)
            got = stream_decode.stream_scatter_add_cuda(
                it, vt, nb * (-(-n // nb)))
            want = ref.stream_scatter_add_ref(it, vt, got.numel())
            check(bits_equal(got, want), "the scatter kernel differs from "
                  "its plain version at the embed decode")
            row = scatter_row(f"fl.{tag}", it, vt, got.numel(), device,
                              plain_reps=1)
            row["max_abs_err"] = (got - want).abs().max().item()
            del got, want
        del out, c, h, gs, rs
        gc.collect()
        torch.cuda.empty_cache()
    return row


def card_mesh(mesh):
    """``mesh`` with every position on ``cuda:0``, given as a device
    array (``LogicalMesh``'s per-position constructor)."""
    import numpy as np
    import torch

    shape = mesh.devices.shape
    return type(mesh)(shape, mesh.axis_names,
                      np.full(shape, torch.device("cuda", 0), dtype=object))


def keep_gradients(step, keep: dict, to=None):
    """Wrap ``step.gradients`` so that it also stores participant ``p``'s
    gradients in ``keep[p]`` (moved to ``to`` when given) for every ``p``
    already in ``keep``, and each participant's gradient devices in
    ``keep["devices"]``. The wrapper holds the class's function, not the
    step: no reference cycle keeps the step's tensors alive."""
    inner = type(step).gradients

    def gradients(params, batch):
        keep["devices"] = []
        for p, (loss, g) in enumerate(inner(step_ref(), params, batch)):
            keep["devices"].append(sorted({str(t.device)
                                           for t in g.values()}))
            if p in keep:
                keep[p] = g if to is None else {
                    n: t.to(to) for n, t in g.items()}
            yield loss, g
            del g

    step_ref = weakref.ref(step)
    step.gradients = gradients


def stream_bits(record, p: int) -> list:
    """Participant ``p``'s stream of every unit of a v1 ``record``."""
    return [(r["streams"][p].indices, r["streams"][p].values)
            for r in record]


def params_gap(a, b) -> tuple[float, int, int, str]:
    """(max |a - b|, elements apart, elements, the worst parameter) of two
    models' parameters, on ``a``'s device."""
    err, moved, total, worst = 0.0, 0, 0, ""
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        d = (p - q.to(p.device)).abs()
        moved += int((d > 0).sum())
        total += d.numel()
        if d.max().item() > err:
            err, worst = d.max().item(), n
    return err, moved, total, worst


def same_params(a, b) -> bool:
    return all(bits_equal(p, q.to(p.device))
               for p, q in zip(a.parameters(), b.parameters()))


def fl_parity(card: str):
    """(b) Yi-6B at full width, PARITY_LAYERS layer(s), f32 (TF32 off), B 2
    x T 512, on
    the multi-pod layout: one v1 step on the card against the CPU (loss;
    params, where a top-k flip moves an element by its whole update).
    Then (d), placement: the same step with every position on ``cuda:0``
    by a device array (i), all on the CPU ((b)'s CPU run, ii), and pod 0
    on ``cuda:0``, pod 1 on the CPU (iii); v2 steps on (i) and (iii).
    The card's step runs here, the CPU's on a worker thread (``on_host``)
    while the card runs (c). Returns the function that joins it, holds
    (b), runs (d) and returns (iii)'s v1 step's launches."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mesh, thgs, sa = fl_config(layers=PARITY_LAYERS, dtype="float32")
    model = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    cpu_model = tf.init_params(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    cpu_batch = lm_batch(cfg, FL_PARITY_B, FL_PARITY_T, 3, "cpu")
    batch = {k: v.cuda() for k, v in cpu_batch.items()}
    state0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    cpu_mesh = type(mesh)(mesh.devices.shape, mesh.axis_names, "cpu")
    key = threefry.key(0)
    out, kept = {}, {"cuda": {0: None}, "cpu": {1: None}}

    def run(dev, m, mesh_):
        step = ttrain.make_fl_train_step(cfg, mesh_, "pod", thgs, sa,
                                         lr=FL_LR)
        keep_gradients(step, kept[dev], to="cuda")
        res = ttrain.init_fl_residuals(m, 2)
        b = batch if dev == "cuda" else cpu_batch
        record = []
        t0 = time.perf_counter()
        _, _, loss = step(m, res, b, key, record=record)
        out[dev] = (loss.item(), time.perf_counter() - t0, res, record)

    run("cuda", model, mesh)
    job = on_host(lambda: run("cpu", cpu_model, cpu_mesh))

    def finish() -> dict:
        job()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        loss_err = abs(out["cuda"][0] - out["cpu"][0])
        param_err, moved, total, worst = params_gap(model, cpu_model)
        moved_any = sum(int((p != state0[n]).sum())
                        for n, p in model.named_parameters())
        print(f"[fl_train] (b) v1 step {cfg.name} full width, "
              f"{cfg.n_layers} layer(s), f32 "
              f"(TF32 off), B={FL_PARITY_B} T={FL_PARITY_T}, pod 2 x data 16 "
              f"x model 16 on {card}: loss card {out['cuda'][0]:.7f} CPU "
              f"{out['cpu'][0]:.7f} |diff| {loss_err:.3e} (tolerance "
              f"{FL_LOSS_TOL}); params max |diff| {param_err:.3e} at {worst} "
              f"(tolerance {FL_PARAM_TOL}), {moved} of {total} elements "
              f"differ (share tolerance {FL_MOVED_SHARE}), {moved_any} moved "
              f"by the step; card {out['cuda'][1]:.2f} s, CPU "
              f"{out['cpu'][1]:.2f} s (on a worker thread while the card ran "
              f"(c))", flush=True)
        check(loss_err <= FL_LOSS_TOL, f"FL loss card vs CPU {loss_err:.3e}")
        check(param_err <= FL_PARAM_TOL and moved <= FL_MOVED_SHARE * total,
              f"FL params card vs CPU {param_err:.3e}, {moved} elements")
        check(moved_any > 0, "the FL step moved no parameter")
        counts = fl_placement(card, cfg, mesh, thgs, sa, model, state0,
                              batch, out, kept)
        out.clear()
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
        return counts

    return finish


def fl_placement(card: str, cfg, mesh, thgs, sa, model_b, state0, batch,
                 out: dict, kept: dict) -> dict:
    """(d) placement, from (b)'s state0, batch and runs: ``out`` holds (b)'s
    card run and (ii), the CPU run (loss, s, residuals, record); ``kept``
    participant 0's card and participant 1's CPU gradients of those runs,
    on the card."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    key = threefry.key(0)
    cuda0, cpu = torch.device("cuda", 0), torch.device("cpu")
    mesh_i = card_mesh(mesh)
    mesh_iii = type(mesh)(mesh.devices.shape, mesh.axis_names,
                          [cuda0, cpu])         # one device a pod

    def fresh():
        m = tf.init_params(cfg, device="meta").to_empty(device=cuda0)
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(state0[n])
        return m

    # (i) every position on cuda:0 through the device array
    model_i = fresh()
    step_i = ttrain.make_fl_train_step(cfg, mesh_i, "pod", thgs, sa,
                                       lr=FL_LR)
    res_i = ttrain.init_fl_residuals(model_i, 2, mesh_i, "pod")
    rec_i = []
    t0 = time.perf_counter()
    _, _, loss_i = step_i(model_i, res_i, batch, key, record=rec_i)
    loss_i = loss_i.item()
    t_i = time.perf_counter() - t0
    _, _, res_b, rec_b = out["cuda"]
    same_i = {
        "params": same_params(model_i, model_b),
        "residuals": all(bits_equal(a, b) for a, b in zip(res_i, res_b)),
        "loss": bits_equal(torch.tensor(loss_i),
                           torch.tensor(out["cuda"][0])),
        "streams": all(bits_equal(a, c) and bits_equal(b, d)
                       for p in (0, 1) for (a, b), (c, d) in zip(
                           stream_bits(rec_i, p), stream_bits(rec_b, p)))}
    print(f"[fl_train] (d)(i) every position on cuda:0 by a device array "
          f"on {card}: v1 step {t_i:.2f} s, loss {loss_i:.7f}; bit-equal "
          f"to (b)'s one-device step {same_i}", flush=True)
    check(all(same_i.values()), f"(d)(i) differs from the one-device step: "
          f"{same_i}")
    del model_b, res_b, rec_b
    gc.collect()

    # (iii) pod 0 on cuda:0, pod 1 on the CPU, the parameters on cuda:0
    model_iii = fresh()
    step_iii = ttrain.make_fl_train_step(cfg, mesh_iii, "pod", thgs, sa,
                                         lr=FL_LR)
    res_iii = ttrain.init_fl_residuals(model_iii, 2, mesh_iii, "pod")
    rec_iii = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, loss_iii = step_iii(model_iii, res_iii, batch, key,
                              record=rec_iii)
    loss_iii = loss_iii.item()
    t_iii = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_units = len(step_iii.units(*step_iii.layout(model_iii)))
    _, t_ii, res_ii, rec_ii = out["cpu"]
    on = {"streams 0": {str(st.indices.device) for st in
                        (r["streams"][0] for r in rec_iii)},
          "streams 1": {str(st.indices.device) for st in
                        (r["streams"][1] for r in rec_iii)},
          "rows 0": {str(r[0].device) for r in res_iii},
          "rows 1": {str(r[1].device) for r in res_iii}}
    replica = step_iii.replicas[cpu][1]
    same_iii = {
        "streams 0 = (i)'s": all(
            bits_equal(a, c) and bits_equal(b, d) for (a, b), (c, d) in
            zip(stream_bits(rec_iii, 0), stream_bits(rec_i, 0))),
        "streams 1 = (ii)'s": all(
            bits_equal(a, c) and bits_equal(b, d) for (a, b), (c, d) in
            zip(stream_bits(rec_iii, 1), stream_bits(rec_ii, 1))),
        "rows 0 = (i)'s": all(bits_equal(a[0], b[0])
                              for a, b in zip(res_iii, res_i)),
        "rows 1 = (ii)'s": all(bits_equal(a[1], b[1])
                               for a, b in zip(res_iii, res_ii)),
        "CPU replica = state0": all(
            bits_equal(p.cpu(), state0[n].cpu())
            for n, p in replica.named_parameters())}
    # the exchange on the cuda:0 mesh fed participant 0's card and
    # participant 1's CPU gradients (moved to the card)
    model_o = fresh()
    res_o = ttrain.init_fl_residuals(model_o, 2, mesh_i, "pod")
    step_i.exchange(model_o, res_o, [kept["cuda"][0], kept["cpu"][1]], key)
    same_iii["params = exchange of the same gradients"] = same_params(
        model_iii, model_o)
    err, moved, total, worst = params_gap(model_iii, model_i)
    print(f"[fl_train] (d)(iii) pod 0 on cuda:0, pod 1 on the CPU, home "
          f"cuda:0, on {card}: v1 step {t_iii:.2f} s (i {t_i:.2f} s, ii "
          f"{t_ii:.2f} s; {torch.get_num_threads()} CPU threads), loss "
          f"{loss_iii:.7f}; placed {on}; launches "
          f"{counts} ({n_units} units); bit-equal {same_iii}; params vs "
          f"(i) max |diff| {err:.3e} at {worst} (tolerance "
          f"{FL_PARAM_TOL}), {moved} of {total} elements differ (share "
          f"tolerance {FL_MOVED_SHARE})", flush=True)
    check(on == {"streams 0": {"cuda:0"}, "streams 1": {"cpu"},
                 "rows 0": {"cuda:0"}, "rows 1": {"cpu"}},
          f"(d)(iii) placement {on}")
    check(all(same_iii.values()), f"(d)(iii): {same_iii}")
    check(err <= FL_PARAM_TOL and moved <= FL_MOVED_SHARE * total,
          f"(d)(iii) params vs (i) {err:.3e}, {moved} elements")
    check(counts["stream_scatter_add"] == n_units,
          f"(d)(iii) launched the scatter {counts['stream_scatter_add']} "
          f"times for {n_units} units")
    del model_o, res_o, rec_iii, res_iii, rec_i, res_i, out, kept
    gc.collect()

    # v2 on (i), then on (iii), from state0
    v2 = {}
    for tag, mesh_, m in (("i", mesh_i, model_i), ("iii", mesh_iii,
                                                   model_iii)):
        with torch.no_grad():
            for n, p in m.named_parameters():
                p.copy_(state0[n])
        step = ttrain.make_fl_train_step_v2(cfg, mesh_, "pod", thgs, sa,
                                            lr=FL_LR)
        seen = {}
        keep_gradients(step, seen)
        res = ttrain.init_fl_residuals(m, 2, mesh_, "pod")
        record = []
        t0 = time.perf_counter()
        _, _, loss = step(m, res, batch, key, record=record)
        loss = loss.item()
        t = time.perf_counter() - t0
        finite = math.isfinite(loss) and all(
            bool(torch.isfinite(p).all()) for p in m.parameters())
        cancel = fl_cancel_v2(step, m, record, key)
        v2[tag] = seen["devices"]
        print(f"[fl_train] (d) v2 step on ({tag}) on {card}: {t:.2f} s, "
              f"loss {loss:.7f}, params finite {finite}, gradients on "
              f"{seen['devices']}; {cancel['text']}", flush=True)
        check(finite, f"non-finite params or loss after the v2 step ({tag})")
        check(cancel["ok"], f"v2 masks do not cancel on ({tag}): "
              f"{cancel['text']}")
        del res, record
    err, moved, total, worst = params_gap(model_iii, model_i)
    print(f"[fl_train] (d) v2 (iii) vs (i): params max |diff| {err:.3e} at "
          f"{worst} (tolerance {FL_PARAM_TOL}), {moved} of {total} elements "
          f"differ", flush=True)
    check(v2["iii"] == [["cuda:0"], ["cpu"]] and v2["i"] == [["cuda:0"]] * 2,
          f"v2 gradients made on {v2}")
    check(err <= FL_PARAM_TOL, f"v2 (iii) vs (i) params {err:.3e}")
    del model_i, model_iii
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def fl_cancel(masked, unmasked, n_mask_slots: int, what: str) -> dict:
    """The masked exchange against the exchange of the unmasked sparse
    parts (the same streams, each mask slot's mask value taken off)."""
    import torch

    err = (masked - unmasked).abs().max().item()
    ok = bool(torch.allclose(masked, unmasked, rtol=FL_CANCEL_TOL,
                             atol=FL_CANCEL_TOL)) and n_mask_slots > 0
    return {"ok": ok, "text": (
        f"masks cancel on {what}: masked vs unmasked exchange max |diff| "
        f"{err:.3e} (rtol = atol = {FL_CANCEL_TOL}), {n_mask_slots} "
        f"non-zero mask values")}


def fl_cancel_v2(step, model, record, round_key) -> dict:
    """The mask check on v2's ``embed`` leaf (the pair-key matrix's
    masks regenerated and taken off the streams' mask slots)."""
    import torch

    from repro_torch import convert
    from repro_torch.core import streams as se
    from repro_torch.core import threefry
    from repro_torch.core.blocked import decode_blocked_sum

    leaves = convert.reference_leaves(model)
    lid = [lf.path for lf in leaves].index("embed")
    st = next(r["streams"] for r in record if r["leaf"] == lid)
    km = step.k_mask(int(torch.tensor(leaves[lid].shape).prod()),
                     st.indices.shape[1])
    nb = st.indices.shape[1]
    kb = st.indices.shape[2] - 2 * km
    keys, signs = se.fold_pair_key_matrix(threefry.fold_in(round_key, lid),
                                          2)
    vals = st.values.clone()
    m = math.prod(leaves[lid].shape) // nb       # the aligned view's rows
    nz = 0
    for p in range(2):
        _, m_vals = se.pairwise_mask_rows(keys[p], signs[p], nb, km, m,
                                          p=step.sa.p, q=step.sa.q,
                                          device=vals.device)
        vals[p, :, kb:] -= m_vals
        nz += int((m_vals != 0).sum())
    masked = decode_blocked_sum(st.indices, st.values, nb * m, nb, 0.5)
    unmasked = decode_blocked_sum(st.indices, vals, nb * m, nb, 0.5)
    return fl_cancel(masked, unmasked, nz, "v2 embed")


def fl_yi6b(card: str) -> dict:
    """(c) Yi-6B whole, bf16, seed 0, federated over 2 participants on the
    multi-pod layout: FL_STEPS v1 steps (the last with its parts timed)
    and a profiled one more. Returns the scatter launches of the FL_STEPS
    steps."""
    import torch

    from repro_torch import convert
    from repro_torch.core import threefry
    from repro_torch.kernels import ops
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.fl_train import step_wire_record
    from repro_torch.models import transformer as tf
    from repro_torch.sim import CommLedger

    cfg, mesh, thgs, sa = fl_config()
    mesh = card_mesh(mesh)
    gc.collect()        # nothing of the earlier cases in the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = tf.param_count(params)
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", thgs, sa, lr=FL_LR,
                                     server_lr=1.0, n_micro=1)
    residuals = ttrain.init_fl_residuals(params, 2)
    batch = lm_batch(cfg, FL_B, FL_T, 0, "cuda")
    leaves = convert.reference_leaves(params)
    named = dict(params.named_parameters())
    before = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    losses, times, parts, record = [], [], {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i in range(FL_STEPS):
        t0 = time.perf_counter()
        last = i == FL_STEPS - 1
        _, _, loss = step(params, residuals, batch, threefry.key(i),
                          timings=parts if last else None,
                          record=record if last else None)
        losses.append(loss.item())
        times.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    out = {}
    prof = profiled(lambda: out.update(loss=step(
        params, residuals, batch, threefry.key(FL_STEPS))[2]), top=6,
        name_len=80)
    losses.append(out["loss"].item())

    # every leaf's aggregate, params and residuals
    paths = [lf.path for lf in leaves]
    agg = {p: 0.0 for p in paths}
    for r in record:
        agg[paths[r["leaf"]]] = max(agg[paths[r["leaf"]]],
                                    r["agg_absmax"].item())
    changed = {}
    for lf in leaves:
        changed[lf.path] = sum(
            int((named[n] != before[n].to(named[n].device)).sum())
            for n in lf.names)
    res_ok = {lf.path: bool(torch.isfinite(r).all()) and bool(r.any())
              for lf, r in zip(leaves, residuals)}
    # masks cancel on lm_head (the last step's streams, masks regenerated)
    cancel = fl_cancel_v1(step, params, record, threefry.key(FL_STEPS - 1),
                          "lm_head")
    slots = sum(st.indices.numel() for x in record for st in x["streams"])
    ledger = CommLedger()
    ledger.record(step_wire_record(0, [math.prod(lf.shape) for lf in leaves],
                                   thgs, sa, 2, mesh.size // 2))
    tpu = ledger.totals("tpu")
    step_ms = statistics.median(times[1:] or times)
    tokens = FL_B * FL_T
    print(f"[fl_train] (c) {cfg.name} whole ({cfg.n_layers} layers, "
          f"{n_params} parameters, bf16, seed 0) federated over 2 "
          f"participants, pod 2 x data 16 x model 16 (256 blocks a "
          f"participant) on {card}: B={FL_B} T={FL_T} (2 rows a "
          f"participant), n_micro 1, lr {FL_LR}, server_lr 1, THGS "
          f"{FL_THGS}, mask ratio {FL_MASK_RATIO}; set-up {setup_s:.1f} s; "
          f"losses {losses} (steps 1-{FL_STEPS}, then the profiled step); "
          f"step ms {[round(t, 3) for t in times]}, median of steps "
          f"{min(2, FL_STEPS)}-{FL_STEPS} {step_ms:.3f} ms "
          f"({tokens / step_ms * 1e3:.1f} "
          f"tokens/s); step {FL_STEPS}'s parts (ms, device synchronized at "
          f"each): { {k: round(v, 3) for k, v in parts.items()} }; peak "
          f"memory {peak_gib:.2f} GiB; launches in steps 1-{FL_STEPS} "
          f"{counts}", flush=True)
    print(f"[fl_train] (c) profiled step {FL_STEPS + 1}: wall "
          f"{prof['wall_ms']:.3f} ms, {prof['kernels']} kernels, device "
          f"{prof['device_ms']:.3f} ms (busy {prof['busy']:.1%}); scatter "
          f"kernels {prof['scatter_kernels']} (two a launch) "
          f"{prof['scatter_ms']:.3f} ms; top: "
          + "; ".join(f"{k} x{c} {t:.3f} ms" for k, c, t in prof["top"]),
          flush=True)
    print(f"[fl_train] (c) exchange: {slots} stream entries in step "
          f"{FL_STEPS} against {2 * n_params} dense ({slots / 2 / n_params:.4%}"
          f"); step_wire_record (tpu accounting) upload_vs_dense "
          f"{tpu['upload_vs_dense']:.6f}; per leaf max |aggregate| "
          f"{ {k: float(f'{v:.3e}') for k, v in agg.items()} }; elements "
          f"changed after {FL_STEPS + 1} steps {changed}; residuals finite "
          f"and non-zero {all(res_ok.values())}; {cancel['text']}",
          flush=True)
    check(all(map(math.isfinite, losses)), f"a non-finite loss: {losses}")
    check(counts["stream_scatter_add"] == FL_UNITS * FL_STEPS,
          f"{counts['stream_scatter_add']} scatter launches in "
          f"{FL_STEPS} steps, expected {FL_UNITS} a step")
    check(prof["scatter_kernels"] == 2 * FL_UNITS,
          f"the profiled step ran {prof['scatter_kernels']} scatter "
          f"kernels, expected {2 * FL_UNITS}")
    check(all(v > 0 for v in agg.values()), f"a zero aggregate: {agg}")
    matrices = [lf.path for lf in leaves if len(lf.shape) - len(lf.lead) >= 2]
    check(all(changed[p] > 0 for p in matrices),
          f"a matrix leaf did not change: {changed}")
    check(all(res_ok.values()), f"residuals not finite and non-zero: "
          f"{res_ok}")
    check(cancel["ok"], cancel["text"])
    del params, residuals, before, record, batch, out
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def sharded_state(lm) -> dict:
    """A sharded model's chunks and copies, cloned where they lie."""
    return {(g, n): t.detach().clone() for g, c in enumerate(lm.chunks)
            for n, t in c.items()}


def group_gradient_spy(plain: dict, seen: list):
    """Wrap ``fsdp.group_value_and_grad`` so that every group's loss and
    gradients (each gathered whole on the group's device) are held,
    bit for bit, against ``launch.train.value_and_grad`` of the one-device
    model ``plain[device.type]`` on the same rows. Returns the function to
    restore."""
    import torch

    from repro_torch.launch import fsdp
    from repro_torch.launch import train as ttrain

    real = fsdp.group_value_and_grad

    def spy(lm, g, cfg, batch):
        loss, gr = real(lm, g, cfg, batch)
        dev = lm.groups[g][0]
        want_loss, want = ttrain.value_and_grad(plain[dev.type], cfg, batch)
        off = [] if bits_equal(loss, want_loss) else [
            f"loss {abs(loss.item() - want_loss.item()):.3e}"]
        for n, w in want.items():
            d = lm.dims[n]
            got = (gr[(None, n)] if d is None else torch.cat(
                [gr[(h, n)].to(dev) for h in range(len(lm.groups))], d))
            if not bits_equal(got, w):
                off.append(f"{n} {(got - w).abs().max().item():.3e}")
        if off:     # is the one-device run itself repeatable there?
            again_loss, again = ttrain.value_and_grad(plain[dev.type], cfg,
                                                      batch)
            off.append("one-device run repeats bit for bit: " + str(
                bits_equal(again_loss, want_loss) and all(
                    bits_equal(again[n], w) for n, w in want.items())))
        seen.append((str(dev), not off, off[:4] + off[-1:] if off else []))
        return loss, gr

    fsdp.group_value_and_grad = spy
    return real


def fl_sharded(card: str) -> dict:
    """(e) one participant over its data positions, on (b)'s multi-pod
    layout, Yi-6B at PARITY_LAYERS layer(s), f32 (TF32 off), B FL_B x T
    FL_SHARD_T (2 rows
    a participant, one a group). (i) each participant's data 0-7 and 8-15
    as two explicit groups on ``cuda:0``: v1 and v2 steps bit-equal to the
    one-device step at n_micro 2 (params, residuals, loss, streams). (ii)
    data 0-7 of each pod on ``cuda:0``, 8-15 on the CPU: every chunk and
    residual chunk on its device; each group's gradients bit-equal to the
    one-device run of its device on its rows; params within FL_PARAM_TOL of
    (i), at most FL_MOVED_SHARE apart; the scatter launches counted; v2's
    masks cancel. Returns (ii)'s v1 launches."""
    import numpy as np
    import torch

    from repro_torch.core import threefry
    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, mesh, thgs, sa = fl_config(layers=PARITY_LAYERS, dtype="float32")
    cuda0, cpu = torch.device("cuda", 0), torch.device("cpu")
    mesh_1 = card_mesh(mesh)
    halves = [(cuda0, range(0, 8)), (cuda0, range(8, 16))]
    devs = np.empty(mesh.devices.shape, dtype=object)
    devs[:, :8], devs[:, 8:] = cuda0, cpu
    mesh_ii = type(mesh)(mesh.devices.shape, mesh.axis_names, devs)
    model0 = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    state0 = {n: p.detach().clone() for n, p in model0.named_parameters()}
    batch = lm_batch(cfg, FL_B, FL_SHARD_T, 5, "cuda")
    key = threefry.key(0)

    def fresh_model():
        with torch.no_grad():
            for n, p in model0.named_parameters():
                p.copy_(state0[n])
        return model0

    def run(version, params, mesh_, groups, n_micro, res):
        mk = (ttrain.make_fl_train_step if version == "v1"
              else ttrain.make_fl_train_step_v2)
        step = mk(cfg, mesh_, "pod", thgs, sa, lr=FL_LR, n_micro=n_micro,
                  groups=groups)
        record = []
        t0 = time.perf_counter()
        _, _, loss = step(params, res, batch, key, record=record)
        loss = loss.item()
        return step, record, loss, time.perf_counter() - t0

    def streams_of(record):
        out = []
        for r in record:
            sts = r["streams"] if isinstance(r["streams"], list) \
                else [r["streams"]]
            out += [(st.indices, st.values) for st in sts]
        return out

    out = {}
    for version in ("v1", "v2"):
        # the one-device step at n_micro 2
        m1 = fresh_model()
        res_1 = ttrain.init_fl_residuals(m1, 2)
        _, rec_1, loss_1, t_1 = run(version, m1, mesh_1, None, 2, res_1)
        want_p = {n: p.detach().clone() for n, p in m1.named_parameters()}
        # (i) two groups a participant on cuda:0
        lm = fsdp.shard(fresh_model(), mesh_1, "pod", groups=halves)
        res_i = ttrain.init_fl_residuals(lm, 2, mesh_1, "pod",
                                         groups=[halves] * 2)
        _, rec_i, loss_i, t_i = run(version, lm, mesh_1, [halves] * 2, 1,
                                    res_i)
        same = {
            "params": all(bits_equal(lm.full(n, cuda0), w)
                          for n, w in want_p.items()),
            "residuals": all(bits_equal(a.cpu(), b.cpu()) for a, b in zip(
                ttrain.stacked_residuals(res_1),
                ttrain.stacked_residuals(res_i))),
            "loss": bits_equal(torch.tensor(loss_1), torch.tensor(loss_i)),
            "streams": all(bits_equal(a, c) and bits_equal(b, d)
                           for (a, b), (c, d) in zip(streams_of(rec_1),
                                                     streams_of(rec_i)))}
        print(f"[fl_train] (e)(i) {version} on {card}: each participant's "
              f"data 0-7 and 8-15 as two groups on cuda:0, {cfg.name} "
              f"{cfg.n_layers} layer(s) f32, B={FL_B} T={FL_SHARD_T}: {t_i:.2f} s (the "
              f"one-device n_micro 2 step {t_1:.2f} s), loss {loss_i:.7f}; "
              f"bit-equal to the one-device step {same}", flush=True)
        check(all(same.values()), f"(e)(i) {version} differs from the "
              f"one-device n_micro 2 step: {same}")
        out[version] = {n: lm.full(n, cuda0) for n in lm.shapes}
        del lm, res_i, rec_i, rec_1, res_1, want_p
        gc.collect()

    # (ii) data 0-7 on cuda:0, 8-15 on the CPU
    plain = {"cuda": fresh_model(), "cpu": tf.init_params(cfg, device="cpu")}
    plain["cpu"].load_state_dict(plain["cuda"].state_dict())
    seen: list = []
    lm = fsdp.shard(fresh_model(), mesh_ii, "pod")
    res_ii = ttrain.init_fl_residuals(lm, 2, mesh_ii, "pod")
    placed = {
        "chunks": [sorted({str(t.device) for t in c.values()})
                   for c in lm.chunks],
        "rows": sorted({tuple(str(p.device) for p in r.parts)
                        for row in res_ii for r in row})}
    real = group_gradient_spy(plain, seen)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step, rec_ii, loss_ii, t_ii = run("v1", lm, mesh_ii, None, 1, res_ii)
        counts = ops.launch_counts()
    finally:
        fsdp.group_value_and_grad = real
    n_units = len(step.units(*step.layout(lm)))
    placed["streams"] = sorted({str(st.indices.device) for r in rec_ii
                                for st in r["streams"]})
    err, moved, total = 0.0, 0, 0
    for n, w in out["v1"].items():
        d = (lm.full(n, cuda0) - w).abs()
        err = max(err, d.max().item())
        moved += int((d > 0).sum())
        total += d.numel()
    print(f"[fl_train] (e)(ii) v1 on {card}: data 0-7 of each pod on cuda:0, "
          f"8-15 on the CPU: {t_ii:.2f} s ({torch.get_num_threads()} CPU "
          f"threads), loss {loss_ii:.7f}; placed {placed}; each group's "
          f"gradients against the one-device run of its device {seen}; "
          f"launches {counts} ({n_units} units); params vs (i) max |diff| "
          f"{err:.3e} (tolerance {FL_PARAM_TOL}), {moved} of {total} "
          f"elements differ (share tolerance {FL_MOVED_SHARE})", flush=True)
    check(placed["chunks"] == [["cuda:0"], ["cpu"]]
          and placed["rows"] == [("cuda:0",), ("cuda:0", "cpu")]
          and placed["streams"] == ["cuda:0"], f"(e)(ii) placement {placed}")
    check(len(seen) == 4 and all(ok for _, ok, _ in seen),
          f"(e)(ii) group gradients vs the one-device runs: {seen}")
    check(err <= FL_PARAM_TOL and moved <= FL_MOVED_SHARE * total,
          f"(e)(ii) params vs (i) {err:.3e}, {moved} elements")
    check(counts["stream_scatter_add"] == n_units,
          f"(e)(ii) launched the scatter {counts['stream_scatter_add']} "
          f"times for {n_units} units")
    del rec_ii, res_ii, plain
    gc.collect()

    # v2 on (ii)
    with torch.no_grad():
        for n, w in state0.items():
            lm.load_(n, w)
    res_ii = ttrain.init_fl_residuals(lm, 2, mesh_ii, "pod")
    step, rec, loss, t = run("v2", lm, mesh_ii, None, 1, res_ii)
    cancel = fl_cancel_v2(step, lm.meta, rec, key)
    err = max((lm.full(n, cuda0) - w).abs().max().item()
              for n, w in out["v2"].items())
    finite = math.isfinite(loss) and all(
        bool(torch.isfinite(t_).all()) for _, t_ in lm.tensors())
    print(f"[fl_train] (e)(ii) v2 on {card}: {t:.2f} s, loss {loss:.7f}, "
          f"params finite {finite}, max |diff| vs (i) {err:.3e} (tolerance "
          f"{FL_PARAM_TOL}); {cancel['text']}", flush=True)
    check(finite, "non-finite params or loss after the (e)(ii) v2 step")
    check(cancel["ok"], f"v2 masks do not cancel on (e)(ii): "
          f"{cancel['text']}")
    check(err <= FL_PARAM_TOL, f"(e)(ii) v2 vs (i) params {err:.3e}")
    del lm, res_ii, rec, out, model0, state0, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def fl_tp(card: str) -> dict:
    """(f) Yi-6B whole, bf16, seed 0, federated over 2 participants, each
    ``(data 1, model 2)`` with both positions on ``cuda:0``
    (``launch/tp.py``), B FL_B x T FL_T: one v1 step (counts reset and
    read: FL_UNITS scatter launches) against the one-device v1 step on the
    same (2, 1, 2) layout (params within FL_TP_PARAM_TOL, at most
    FL_MOVED_SHARE of the elements apart); every loss, leaf and residual
    finite, every matrix leaf moved. Then one v2 step at the same size on
    the same grid (each cell encodes its own block of the aligned view, one
    participant at a time: the whole model fits) against the one-device v2
    step from the same state (params within FL_TP_PARAM_TOL, at most
    FL_MOVED_SHARE apart): one scatter launch a reference leaf, the masks
    cancel, no byte gathered on an aligned leaf, peak <= FL_PEAK_GIB.
    Returns the v1 step's launches."""
    import torch

    from repro_torch import convert
    from repro_torch.core.blocked import sharding_aligned_transform
    from repro_torch.core import threefry
    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    cfg, _, thgs, sa = fl_config()
    cuda0 = torch.device("cuda", 0)
    mesh = tmesh.LogicalMesh((2, 1, 2), ("pod", "data", "model"), "cuda:0")
    grid_ = [((cuda0, cuda0), range(0, 1))]
    batch = lm_batch(cfg, FL_B, FL_T, 0, "cuda")
    key = threefry.key(0)

    def draw():
        return tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))

    gc.collect()
    torch.cuda.empty_cache()
    model = draw()
    res = ttrain.init_fl_residuals(model, 2)
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", thgs, sa, lr=FL_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_1 = step(model, res, batch, key)[2].item()
    torch.cuda.synchronize()
    ms_1 = (time.perf_counter() - t0) * 1e3
    want = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, res, step
    gc.collect()
    torch.cuda.empty_cache()

    lm = fsdp.shard(draw(), mesh, "pod", groups=grid_)
    res = ttrain.init_fl_residuals(lm, 2, mesh, "pod", groups=[grid_] * 2)
    step = ttrain.make_fl_train_step(cfg, mesh, "pod", thgs, sa, lr=FL_LR,
                                     groups=[grid_] * 2)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss_v1 = step(lm, res, batch, key)[2].item()
    torch.cuda.synchronize()
    ms_v1 = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    got = {n: lm.full(n, cuda0) for n in lm.shapes}
    err, moved, total, worst = gap_on_card(got, want)
    del want
    leaves = convert.reference_leaves(lm.meta)
    finite = all(bool(torch.isfinite(t).all()) for _, t in lm.tensors())
    res_ok = all(bool(torch.isfinite(r.to(cuda0)).all())
                 for row in res for r in row)
    del lm, res, step
    gc.collect()
    start = dict(draw().named_parameters())
    unmoved = [lf.path for lf in leaves
               if len(lf.shape) - len(lf.lead) >= 2
               and all(bits_equal(got[n], start[n]) for n in lf.names)]
    del got, start
    print(f"[fl_train] (f) tensor parallel on {card}: {cfg.name} whole bf16, "
          f"2 participants each (data 1, model 2) on cuda:0, B={FL_B} "
          f"T={FL_T}: v1 step {ms_v1:.3f} ms "
          f"({FL_B * FL_T / ms_v1 * 1e3:.1f} tokens/s; the one-device step "
          f"{ms_1:.3f} ms), peak {peak / 2**30:.2f} GiB, loss {loss_v1:.6f} "
          f"(one-device {loss_1:.6f}), launches {counts}; params vs the "
          f"one-device step max |diff| {err:.3e} at {worst} (tolerance "
          f"{FL_TP_PARAM_TOL}), {moved} of {total} elements apart (share "
          f"tolerance {FL_MOVED_SHARE}); params finite {finite}, residuals "
          f"finite {res_ok}, matrix leaves unmoved {unmoved}", flush=True)
    check(counts["stream_scatter_add"] == FL_UNITS,
          f"(f) {counts['stream_scatter_add']} scatter launches, expected "
          f"{FL_UNITS}")
    check(math.isfinite(loss_1) and math.isfinite(loss_v1),
          "(f) a non-finite loss")
    check(finite and res_ok, "(f) non-finite params or residuals")
    check(not unmoved, f"(f) matrix leaves did not move: {unmoved}")
    check(err <= FL_TP_PARAM_TOL and moved <= FL_MOVED_SHARE * total,
          f"(f) params vs the one-device step {err:.3e} at {worst}, {moved} "
          f"of {total} apart")
    gc.collect()
    torch.cuda.empty_cache()

    # v2 at the same size on the same grid, against the one-device v2 step
    model = draw()
    res = ttrain.init_fl_residuals(model, 2)
    step = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", thgs, sa,
                                        lr=FL_LR)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss_1v2 = step(model, res, batch, key)[2].item()
    torch.cuda.synchronize()
    ms_1v2 = (time.perf_counter() - t0) * 1e3
    peak_1v2 = torch.cuda.max_memory_allocated()
    want = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, res, step
    gc.collect()
    torch.cuda.empty_cache()

    lm = fsdp.shard(draw(), mesh, "pod", groups=grid_)
    res = ttrain.init_fl_residuals(lm, 2, mesh, "pod", groups=[grid_] * 2)
    step2 = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", thgs, sa,
                                         lr=FL_LR, groups=[grid_] * 2)
    rec: list = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss_v2 = step2(lm, res, batch, key, record=rec)[2].item()
    torch.cuda.synchronize()
    ms_v2 = (time.perf_counter() - t0) * 1e3
    counts_v2 = ops.launch_counts()
    peak_v2 = torch.cuda.max_memory_allocated()
    cancel = fl_cancel_v2(step2, lm.meta, rec, key)
    leaves, specs, _, _ = step2.layout(lm)
    aligned = [sharding_aligned_transform(lf.shape, sp, step2.axis_sizes,
                                          step2.intra_axes) is not None
               for lf, sp in zip(leaves, specs)]
    gathered = {leaves[r["leaf"]].path: r["gathered_bytes"] for r in rec
                if aligned[r["leaf"]] and r["gathered_bytes"]}
    home = sum(r["home_bytes"] for r in rec)
    del rec
    finite = math.isfinite(loss_v2) and all(
        bool(torch.isfinite(t).all()) for _, t in lm.tensors())
    got = {n: lm.full(n, cuda0) for n in lm.shapes}
    err, moved, total, worst = gap_on_card(got, want)
    del got, want, lm, res, step2
    print(f"[fl_train] (f) v2 tensor parallel on {card}: {cfg.name} whole "
          f"bf16, the same grid, B={FL_B} T={FL_T}: v2 step {ms_v2:.3f} ms "
          f"({FL_B * FL_T / ms_v2 * 1e3:.1f} tokens/s; the one-device v2 "
          f"step {ms_1v2:.3f} ms, peak {peak_1v2 / 2**30:.2f} GiB), peak "
          f"{peak_v2 / 2**30:.2f} GiB, loss {loss_v2:.6f} (one-device "
          f"{loss_1v2:.6f}), launches {counts_v2} ({len(leaves)} leaves, "
          f"{sum(aligned)} aligned); gathered on aligned leaves {gathered}, "
          f"stream bytes home {home}; params vs the one-device v2 step max "
          f"|diff| {err:.3e} at {worst} (tolerance {FL_TP_PARAM_TOL}), "
          f"{moved} of {total} elements apart (share tolerance "
          f"{FL_MOVED_SHARE}); params finite {finite}; {cancel['text']}",
          flush=True)
    check(counts_v2["stream_scatter_add"] == len(leaves),
          f"(f) v2: {counts_v2['stream_scatter_add']} scatter launches for "
          f"{len(leaves)} leaves")
    check(math.isfinite(loss_1v2) and finite,
          "(f) v2: a non-finite loss or param")
    check(cancel["ok"], f"(f) v2 masks do not cancel: {cancel['text']}")
    check(not gathered, f"(f) v2 gathered bytes on aligned leaves: "
          f"{gathered}")
    check(peak_v2 <= FL_PEAK_GIB * 2**30,
          f"(f) v2 peaked at {peak_v2 / 2**30:.2f} GiB")
    check(err <= FL_TP_PARAM_TOL and moved <= FL_MOVED_SHARE * total,
          f"(f) v2 params vs the one-device v2 step {err:.3e} at {worst}, "
          f"{moved} of {total} apart")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# (g) DeepSeek-MoE-16B (TP_MOE_LAYERS layers, bf16), each participant over
# (data 1, model 2) on cuda:0, against the one-device step of its version:
# the params' max |diff|. About 2x the readings on an H100 80GB HBM3 at
# 700 W at 8 layers:
# 2.441e-04 at lm_head for v2 and v1 (one bf16 ulp), 127,305 / 92,105 of
# 5,122,328,576 elements apart (2.5e-5 / 1.8e-5, under FL_MOVED_SHARE)
FL_TP_MOE_PARAM_TOL = 4.9e-4


def fl_cancel_v1(step, params, record, round_key, path: str) -> dict:
    """The mask check on v1's whole-leaf unit ``path`` (its masks
    regenerated by ``step.masks_for`` and taken off the streams' mask
    slots)."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.core.blocked import decode_blocked_sum

    layout = step.layout(params)
    leaves = layout[0]
    lid = [lf.path for lf in leaves].index(path)
    r = next(x for x in record if x["leaf"] == lid)
    _, _, nb, kb, km, _ = next(u for u in step.units(*layout)
                               if u[0] == lid)
    size = math.prod(leaves[lid].shape)
    key = threefry.fold_in(round_key, lid)
    idx = torch.stack([st.indices for st in r["streams"]])
    vals = torch.stack([st.values for st in r["streams"]])
    plain = vals.clone()
    nz = 0
    for p in range(len(r["streams"])):
        _, m_vals, _ = step.masks_for(key, p, size, nb, km, None,
                                      vals.device)
        plain[p, :, kb:] -= m_vals
        nz += int((m_vals != 0).sum())
    return fl_cancel(decode_blocked_sum(idx, vals, size, nb, 0.5),
                     decode_blocked_sum(idx, plain, size, nb, 0.5), nz,
                     f"v1 {path}")


def fl_tp_moe(card: str) -> dict:
    """(g) DeepSeek-MoE-16B at full width, TP_MOE_LAYERS layers, bf16, seed
    0, federated over 2 participants, each ``(data 1, model 2)`` with both
    positions on ``cuda:0`` (``launch/tp.py``'s expert-parallel MoE), B
    FL_B x T FL_T. The v2 step (the reference's production step, encoded
    in place) and the v1 step, each against its one-device step on the
    same (2, 1, 2) layout: params within FL_TP_MOE_PARAM_TOL with at most
    FL_MOVED_SHARE apart, the masks cancel (v2 on ``embed``, v1 on
    ``lm_head``), one scatter launch a unit (counts reset and read around
    each grid step; they join the kernel table's), no byte gathered on an
    aligned leaf (v2) and no routed expert byte gathered, the exchange's
    bytes against :func:`exchange_bytes` and the routing broadcast's
    against :func:`route_bytes`, peak <= FL_PEAK_GIB. Returns the
    two grid steps' launches."""
    import torch

    from repro_torch.core.blocked import sharding_aligned_transform
    from repro_torch.core import threefry
    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    _, _, thgs, sa = fl_config()
    cfg = moe_config()
    cuda0 = torch.device("cuda", 0)
    mesh = tmesh.LogicalMesh((2, 1, 2), ("pod", "data", "model"), "cuda:0")
    grid_ = [((cuda0, cuda0), range(0, 1))]
    batch = lm_batch(cfg, FL_B, FL_T, 0, "cuda")
    key = threefry.key(0)
    want_x = exchange_bytes(cfg, FL_B, FL_T, 2)
    want_r = route_bytes(cfg, FL_B, FL_T, 2)
    total_counts = {k: 0 for k in ops.KERNELS}

    def draw():
        return tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))

    for version, make in (("v2", ttrain.make_fl_train_step_v2),
                          ("v1", ttrain.make_fl_train_step)):
        gc.collect()
        torch.cuda.empty_cache()
        model = draw()
        res = ttrain.init_fl_residuals(model, 2)
        step = make(cfg, mesh, "pod", thgs, sa, lr=FL_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_1 = step(model, res, batch, key)[2].item()
        torch.cuda.synchronize()
        ms_1 = (time.perf_counter() - t0) * 1e3
        want = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del model, res, step
        gc.collect()
        torch.cuda.empty_cache()

        lm = fsdp.shard(draw(), mesh, "pod", groups=grid_)
        res = ttrain.init_fl_residuals(lm, 2, mesh, "pod",
                                       groups=[grid_] * 2)
        step = make(cfg, mesh, "pod", thgs, sa, lr=FL_LR,
                    groups=[grid_] * 2)
        rec: list = []
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with tp_traffic(lm) as tally:
            t0 = time.perf_counter()
            loss = step(lm, res, batch, key, record=rec)[2].item()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        total_counts = {k: total_counts[k] + counts[k] for k in counts}
        layout = step.layout(lm)
        leaves, specs = layout[:2]
        units = (len(leaves) if version == "v2"
                 else len(step.units(*layout)))
        cancel = (fl_cancel_v2(step, lm.meta, rec, key) if version == "v2"
                  else fl_cancel_v1(step, lm, rec, key, "lm_head"))
        aligned = [sharding_aligned_transform(lf.shape, sp, step.axis_sizes,
                                              step.intra_axes) is not None
                   for lf, sp in zip(leaves, specs)]
        gathered = {leaves[r["leaf"]].path: r["gathered_bytes"] for r in rec
                    if aligned[r["leaf"]] and r["gathered_bytes"]}
        all_gathered = sum(r["gathered_bytes"] for r in rec)
        del rec
        finite = math.isfinite(loss) and all(
            bool(torch.isfinite(t).all()) for _, t in lm.tensors())
        got = {n: lm.full(n, cuda0) for n in lm.shapes}
        err, moved, total, worst = gap_on_card(got, want)
        del got, want, lm, res, step
        print(f"[fl_train] (g) {version} tensor parallel MoE on {card}: "
              f"{cfg.name} at full width, {cfg.n_layers} of 28 layers, bf16, "
              f"2 participants each (data 1, model 2) on cuda:0, B={FL_B} "
              f"T={FL_T}: step {ms:.3f} ms "
              f"({FL_B * FL_T / ms * 1e3:.1f} tokens/s; the one-device "
              f"step {ms_1:.3f} ms), peak {peak / 2**30:.2f} GiB, loss "
              f"{loss:.6f} (one-device {loss_1:.6f}), launches {counts} "
              f"({units} units, {len(leaves)} leaves, {sum(aligned)} "
              f"aligned); the encode gathered {all_gathered} bytes, "
              f"{gathered if version == 'v2' else 'v1: generic units'} on "
              f"aligned leaves; routed expert bytes gathered "
              f"{tally['expert_gathered']}, exchange {tally['exchange']} "
              f"bytes in {tally['exchange_calls']} calls (hand count "
              f"{want_x}), routing broadcast {tally['route']} bytes (hand "
              f"count {want_r}); params vs the one-device step max |diff| "
              f"{err:.3e} at {worst} (tolerance {FL_TP_MOE_PARAM_TOL}), "
              f"{moved} of {total} elements apart (share tolerance "
              f"{FL_MOVED_SHARE}); params finite {finite}; {cancel['text']}",
              flush=True)
        check(counts["stream_scatter_add"] == units,
              f"(g) {version}: {counts['stream_scatter_add']} scatter "
              f"launches for {units} units")
        check(math.isfinite(loss_1) and finite,
              f"(g) {version}: a non-finite loss or param")
        check(cancel["ok"], f"(g) {version} masks do not cancel: "
              f"{cancel['text']}")
        check(version == "v1" or not gathered,
              f"(g) v2 gathered bytes on aligned leaves: {gathered}")
        check(tally["expert_gathered"] == 0,
              f"(g) {version}: routed expert bytes gathered "
              f"{tally['expert_gathered']}")
        check(tally["exchange"] == want_x,
              f"(g) {version}: exchange {tally['exchange']} bytes, hand "
              f"count {want_x}")
        check(tally["route"] == want_r,
              f"(g) {version}: routing broadcast {tally['route']} bytes, "
              f"hand count {want_r}")
        check(peak <= FL_PEAK_GIB * 2**30,
              f"(g) {version} peaked at {peak / 2**30:.2f} GiB")
        check(err <= FL_TP_MOE_PARAM_TOL and moved <= FL_MOVED_SHARE * total,
              f"(g) {version} params vs the one-device step {err:.3e} at "
              f"{worst}, {moved} of {total} apart")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return total_counts


def fl_tp_ssm(card: str) -> dict:
    """(h) Zamba2-7B at full width, TP_SSM_LAYERS layers, bf16, seed 0,
    federated over 2 participants, each ``(data 1, model 2)`` with both
    positions on ``cuda:0`` (``launch/tp.py``'s head-split mixer), B
    TP_SSM_B x T TP_SSM_T (one row a participant): the v2 step (encoded in
    place) against the one-device v2 step on the same (2, 1, 2) layout:
    params within FL_TP_PARAM_TOL with at most FL_MOVED_SHARE apart, the
    masks cancel on ``embed``, one scatter launch a leaf (counts reset and
    read around the grid step; they join the kernel table's), no byte
    gathered on an aligned leaf, the weight bytes read across positions
    against the hand count (each participant's step: :func:`ssm_across`),
    peak <= FL_PEAK_GIB. Returns the grid step's launches."""
    import torch

    from repro_torch.core.blocked import sharding_aligned_transform
    from repro_torch.core import threefry
    from repro_torch.kernels import ops
    from repro_torch.launch import fsdp
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train as ttrain
    from repro_torch.models import transformer as tf

    _, _, thgs, sa = fl_config()
    cfg = ssm_config()
    cuda0 = torch.device("cuda", 0)
    mesh = tmesh.LogicalMesh((2, 1, 2), ("pod", "data", "model"), "cuda:0")
    grid_ = [((cuda0, cuda0), range(0, 1))]
    batch = lm_batch(cfg, TP_SSM_B, TP_SSM_T, 0, "cuda")
    key = threefry.key(0)
    want_across = 2 * ssm_across(TP_SSM_LAYERS)[0]

    def draw():
        return tf.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))

    gc.collect()
    torch.cuda.empty_cache()
    model = draw()
    res = ttrain.init_fl_residuals(model, 2)
    step = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", thgs, sa,
                                        lr=FL_LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_1 = step(model, res, batch, key)[2].item()
    torch.cuda.synchronize()
    ms_1 = (time.perf_counter() - t0) * 1e3
    want = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model, res, step
    gc.collect()
    torch.cuda.empty_cache()

    lm = fsdp.shard(draw(), mesh, "pod", groups=grid_)
    res = ttrain.init_fl_residuals(lm, 2, mesh, "pod", groups=[grid_] * 2)
    step = ttrain.make_fl_train_step_v2(cfg, mesh, "pod", thgs, sa,
                                        lr=FL_LR, groups=[grid_] * 2)
    rec: list = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with tp_traffic(lm) as tally:
        t0 = time.perf_counter()
        loss = step(lm, res, batch, key, record=rec)[2].item()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cancel = fl_cancel_v2(step, lm.meta, rec, key)
    leaves, specs, _, _ = step.layout(lm)
    aligned = [sharding_aligned_transform(lf.shape, sp, step.axis_sizes,
                                          step.intra_axes) is not None
               for lf, sp in zip(leaves, specs)]
    gathered = {leaves[r["leaf"]].path: r["gathered_bytes"] for r in rec
                if aligned[r["leaf"]] and r["gathered_bytes"]}
    all_gathered = sum(r["gathered_bytes"] for r in rec)
    del rec
    finite = math.isfinite(loss) and all(
        bool(torch.isfinite(t).all()) for _, t in lm.tensors())
    got = {n: lm.full(n, cuda0) for n in lm.shapes}
    err, moved, total, worst = gap_on_card(got, want)
    most = apart_by_leaf(got, want)
    del got, want, lm, res, step
    tokens = TP_SSM_B * TP_SSM_T
    print(f"[fl_train] (h) v2 tensor parallel heads on {card}: {cfg.name} "
          f"at full width, {cfg.n_layers} of 81 layers, bf16, 2 "
          f"participants each (data 1, model 2) on cuda:0, B={TP_SSM_B} "
          f"T={TP_SSM_T}: step {ms:.3f} ms ({tokens / ms * 1e3:.1f} "
          f"tokens/s; the one-device step {ms_1:.3f} ms), peak "
          f"{peak / 2**30:.2f} GiB, loss {loss:.6f} (one-device "
          f"{loss_1:.6f}), launches {counts} ({len(leaves)} leaves, "
          f"{sum(aligned)} aligned); the encode gathered {all_gathered} "
          f"bytes, {gathered} on aligned leaves; weight bytes read across "
          f"positions {tally['across']} (hand count {want_across}), "
          f"scatters from position 0 {tally['scatter_calls']}; params vs "
          f"the one-device step max |diff| {err:.3e} at {worst} (tolerance "
          f"{FL_TP_PARAM_TOL}), {moved} of {total} elements apart (share "
          f"tolerance {FL_MOVED_SHARE}; most in {most}); params finite "
          f"{finite}; {cancel['text']}", flush=True)
    check(counts["stream_scatter_add"] == len(leaves),
          f"(h) {counts['stream_scatter_add']} scatter launches for "
          f"{len(leaves)} leaves")
    check(math.isfinite(loss_1) and finite, "(h) a non-finite loss or param")
    check(cancel["ok"], f"(h) masks do not cancel: {cancel['text']}")
    check(not gathered, f"(h) gathered bytes on aligned leaves: {gathered}")
    check(tally["across"] == want_across,
          f"(h) weight bytes read across positions {tally['across']}, hand "
          f"count {want_across}")
    check(tally["scatter_calls"] == 0,
          f"(h) {tally['scatter_calls']} scatters from position 0")
    check(peak <= FL_PEAK_GIB * 2**30, f"(h) peaked at {peak / 2**30:.2f} GiB")
    check(err <= FL_TP_PARAM_TOL and moved <= FL_MOVED_SHARE * total,
          f"(h) params vs the one-device step {err:.3e} at {worst}, {moved} "
          f"of {total} apart")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def fl_dense_secagg(card: str) -> None:
    """(i) table2_fedavg_quick with dense secure aggregation, 2 rounds on
    the card and on the CPU: the ledgers are equal."""
    from repro_torch.core.types import SecureAggConfig
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get("table2_fedavg_quick").replace(
        out_json=None, rounds=2, sa=SecureAggConfig(mask_ratio=0.01))
    res = {dev: Simulation(cfg, device=dev).run() for dev in ("cuda", "cpu")}
    facts = {dev: [(e.ks, e.k_masks, e.n_clients, e.n_survivors)
                   for e in r.ledger.entries] for dev, r in res.items()}
    same = facts["cuda"] == facts["cpu"] and all(
        res["cuda"].ledger.totals(a) == res["cpu"].ledger.totals(a)
        for a in ("paper", "tpu"))
    print(f"[fl_train] (i) table2_fedavg_quick with dense secure "
          f"aggregation, 2 rounds on {card}: accuracies card "
          f"{res['cuda'].accuracies} CPU {res['cpu'].accuracies}; ledger "
          f"equal {same}", flush=True)
    check(same, "dense secure aggregation: the card's ledger differs from "
          "the CPU's")


def fl_train_phase(card: str, device) -> tuple[dict, dict]:
    """Phase 18: the federated LM train step. Returns the scatter's row at
    the embed decode and the launches of (d)(iii)'s step, (c)'s steps,
    (e)(ii)'s v1 step, (f)'s v1 step, (g)'s steps and (h)'s step."""
    t0 = time.perf_counter()
    row = fl_units_check(card, device)
    t1 = time.perf_counter()
    parity = fl_parity(card)        # the CPU's step runs while the card
    t_b = time.perf_counter()       # runs (c)
    counts = fl_yi6b(card)
    t_c = time.perf_counter()
    placed = parity()
    del parity
    t3 = time.perf_counter()
    sharded = fl_sharded(card)
    t4 = time.perf_counter()
    tp = fl_tp(card)
    t5 = time.perf_counter()
    tp_moe = fl_tp_moe(card)
    t6 = time.perf_counter()
    tp_ssm = fl_tp_ssm(card)
    t7 = time.perf_counter()
    fl_dense_secagg(card)
    print(f"[fl_train] phase 18 took {time.perf_counter() - t0:.1f} s on "
          f"{card} ((a) {t1 - t0:.1f} s, (b) and (d) "
          f"{t_b - t1 + t3 - t_c:.1f} s, (b)'s CPU step meanwhile; (c) "
          f"{t_c - t_b:.1f} s, (e) {t4 - t3:.1f} s, (f) {t5 - t4:.1f} s, (g) "
          f"{t6 - t5:.1f} s, (h) {t7 - t6:.1f} s)", flush=True)
    return row, {k: counts[k] + placed[k] + sharded[k] + tp[k] + tp_moe[k]
                 + tp_ssm[k] for k in counts}


# ----------------------------------------------------- phase 12: resume
RESUME_CUTS = (("table2_quick", 6), ("async_quick", 4))   # (preset, kill at)
SMOKE_DIR = ROOT / "build" / "smoke"       # checkpoints, removed at the end


class Killed(Exception):
    """Raised by a round hook to kill a run after a given round."""


def vgg16_tree(device, n_clients: int = 10) -> dict:
    """VGG16's params (He-normal, seed 0) and ``n_clients`` residuals
    (seeded normals) on the card: the tree a checkpoint of a VGG16 run
    holds."""
    import torch

    from repro_torch.models.paper_models import build_model

    model = build_model("cifar_vgg16").init_(
        torch.Generator().manual_seed(0))
    params = {n: p.detach().to(device) for n, p in model.params().items()}
    g = torch.Generator(device=device).manual_seed(1)
    residuals = {c: {n: 1e-3 * torch.randn(p.shape, generator=g,
                                           device=device)
                     for n, p in params.items()} for c in range(n_clients)}
    return {"params": params, "residuals": residuals}


def resume_in_fresh_process(preset: str, kind: str, ckpt_dir: str,
                            kill_at: int, full_sim, full) -> None:
    """Resume a killed leg's checkpoints with ``python -m repro_torch.sim``
    in a new process (a crash resume always starts one; cuBLAS may choose
    again there) and hold its JSON ledger, accuracies, losses and its final
    checkpoint bit-equal to the uninterrupted run of this process."""
    from repro_torch import checkpoint

    out = os.path.join(ckpt_dir, "resumed.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.sim", "--preset", preset,
         "--ckpt-dir", ckpt_dir, "--ckpt-every", str(kill_at),
         "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    t1 = time.perf_counter()
    check(proc.returncode == 0,
          f"python -m repro_torch.sim resuming {preset} exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        doc = json.load(f)
    want = json.loads(json.dumps(full.summary(), default=float))
    rounds = [int(ln.split()[1]) for ln in proc.stdout.splitlines()
              if ln.startswith("round ")]
    ledger_eq = doc["ledger"]["entries"] == want["ledger"]["entries"]
    accs_eq = doc["accuracies"] == want["accuracies"]
    losses_eq = doc["losses"] == want["losses"]
    like = full_sim._ckpt_tree(full_sim.state)
    back = checkpoint.restore(ckpt_dir, full.rounds, like=like)
    leaves_eq: list = []
    checkpoint.map_leaves(lambda w, b: leaves_eq.append(bits_equal(b, w)),
                          like, back)
    state_eq = bool(leaves_eq) and all(leaves_eq)
    print(f"[resume] {preset} on {kind}, resumed in a fresh process "
          f"(python -m repro_torch.sim --ckpt-dir, {t1 - t0:.1f} s, eval "
          f"rounds {rounds}): against the uninterrupted run: ledger entries "
          f"equal={ledger_eq} accuracies equal={accs_eq} losses equal="
          f"{losses_eq} final checkpoint ({len(leaves_eq)} leaves) "
          f"bit-equal={state_eq}", flush=True)
    check(bool(rounds) and rounds[0] > kill_at,
          f"{preset}: the fresh process evaluated rounds {rounds}; it did "
          f"not resume after round {kill_at}")
    check(checkpoint.latest_step(ckpt_dir) == full.rounds,
          f"{preset}: the fresh process saved no final checkpoint")
    check(ledger_eq and accs_eq and losses_eq,
          f"{preset}: the fresh-process resume's ledger, accuracies or "
          "losses differ from the uninterrupted run")
    check(state_eq, f"{preset}: the fresh-process resume's final params, "
          "residuals or ring differ from the uninterrupted run")


def vgg16_table2(rounds: int = 2):
    """cifar_vgg16 on cifar10 under the table2 protocol (the config of
    phase 5)."""
    from repro_torch.sim import presets

    return presets.get("table2").replace(
        name="table2_vgg16", model="cifar_vgg16", dataset="cifar10",
        rounds=rounds, eval_every=1, out_json=None)


def nondeterministic_cudnn() -> None:
    """Leave cuDNN as far from deterministic as PyTorch allows
    (``deterministic`` off, autotuning on), so that only the engine's own
    setting can make a conv run repeatable."""
    import torch

    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True


def vgg16_sgd_times(kind: str, reps: int = 5) -> dict:
    """VGG16's local SGD (the table2 protocol's first round, 5 clients, one
    ``batched_client_update``) timed with and without deterministic cuDNN,
    in turns, on the host clock after ``synchronize`` (median of ``reps``
    each, after one warm-up call each); autotuning off in both."""
    import torch

    from repro_torch.core import fedavg

    params, batches, loss_fn, fed = round_inputs(vgg16_table2(), "cuda")
    b = torch.backends.cudnn
    old = (b.deterministic, b.benchmark)
    ts = {True: [], False: []}
    deltas = {}
    try:
        for rep in range(reps + 1):
            for det in (True, False):
                b.deterministic, b.benchmark = det, False
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                d, _ = fedavg.batched_client_update(
                    params, batches, loss_fn, fed.local_steps, fed.local_lr)
                torch.cuda.synchronize()
                if rep:
                    ts[det].append(time.perf_counter() - t0)
                deltas.setdefault(det, []).append(d)
    finally:
        b.deterministic, b.benchmark = old
    same = {det: all(bits_equal(x[n], deltas[det][0][n])
                     for x in deltas[det][1:] for n in x) for det in ts}
    ms = {det: 1e3 * statistics.median(ts[det]) for det in ts}
    print(f"[resume] cifar_vgg16 local SGD (5 clients x {fed.local_steps} "
          f"steps of {batches[0].shape[2]}) on {kind}: deterministic cuDNN "
          f"{ms[True]:.3f} ms, its {reps + 1} calls bit-equal={same[True]}; "
          f"without it {ms[False]:.3f} ms, bit-equal={same[False]} "
          f"(median of {reps}, in turns; ratio "
          f"{ms[True] / ms[False]:.3f})", flush=True)
    check(same[True], "VGG16's local SGD under deterministic cuDNN differs "
          "call to call")
    del deltas, params, batches
    torch.cuda.empty_cache()
    return ms


def vgg16_resume_leg(kind: str) -> None:
    """Two plain serial VGG16 engine runs (table2 protocol, 2 rounds), each
    started with cuDNN left non-deterministic, bit-equal: the engine sets
    deterministic cuDNN itself; then the run killed after round 1 and
    resumed, bit-equal to them; then its local SGD timed with and without
    deterministic cuDNN."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sim.engine import Simulation

    cfg = vgg16_table2()
    runs = []
    for _ in range(2):
        nondeterministic_cudnn()
        sim = Simulation(cfg, device="cuda")
        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        check(flags == (True, False), f"the engine left cuDNN at "
              f"deterministic={flags[0]} benchmark={flags[1]}")
        runs.append((sim, sim.run()))
    (a_sim, a), (b_sim, b) = runs
    two_eq = states_equal(a_sim.state, b_sim.state)
    same_log = (a.ledger.entries == b.ledger.entries
                and a.accuracies == b.accuracies and a.losses == b.losses)
    print(f"[resume] cifar_vgg16 table2 on {kind}: two serial runs, each "
          f"started with cuDNN non-deterministic and autotuning: params, "
          f"residuals bit-equal={two_eq}, ledger, accuracies, losses "
          f"equal={same_log} (losses {a.losses})", flush=True)
    check(two_eq == (True, True) and same_log,
          "two serial VGG16 runs of one config and seed differ")
    del runs, b_sim, b
    ckcfg = cfg.replace(ckpt_dir=str(SMOKE_DIR / "vgg16_run"), ckpt_every=1)

    def die(r, info):
        if r + 1 == 1:
            raise Killed

    nondeterministic_cudnn()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        Simulation(ckcfg, device="cuda").run(hooks=[die])
        fail("cifar_vgg16: the kill hook did not fire")
    except Killed:
        pass
    t1 = time.perf_counter()
    nondeterministic_cudnn()
    sim, seen = Simulation(ckcfg, device="cuda"), []
    res = sim.run(hooks=[lambda r, info: seen.append(r)])
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    eq = states_equal(sim.state, a_sim.state)
    same_log = (res.ledger.entries == a.ledger.entries
                and res.accuracies == a.accuracies and res.losses == a.losses)
    print(f"[resume] cifar_vgg16 table2 on {kind}: killed after round 1 "
          f"({t1 - t0:.3f} s, checkpoint included), resumed rounds "
          f"{[r + 1 for r in seen]} ({t2 - t1:.3f} s); against the "
          f"uninterrupted run: params, residuals bit-equal={eq}, ledger, "
          f"accuracies, losses equal={same_log}; launches over both legs="
          f"{counts}", flush=True)
    check(seen == [1], f"cifar_vgg16 resumed at the wrong round: {seen}")
    check(eq == (True, True) and same_log, "the resumed VGG16 run differs "
          "from the uninterrupted run")
    check(counts["pair_mask_streams"] == cfg.rounds,
          f"the VGG16 legs launched pair_mask_streams "
          f"{counts['pair_mask_streams']} times, expected one a round")
    del sim, a_sim, a, res
    torch.cuda.empty_cache()
    vgg16_sgd_times(kind)


def resume_phase(kind: str) -> dict:
    """Each of RESUME_CUTS killed by a hook after its round and resumed to
    the end, against an uninterrupted run in this process; then one VGG16
    checkpoint saved and restored. Returns the two legs' launch counts."""
    import shutil

    import torch

    from repro_torch import checkpoint
    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import simulation_for

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    legs_counts = {}
    for preset, kill_at in RESUME_CUTS:
        cfg = presets.get(preset).replace(out_json=None)
        full_sim = simulation_for(cfg, device="cuda")
        full = full_sim.run()
        ckcfg = cfg.replace(ckpt_dir=str(SMOKE_DIR / preset),
                            ckpt_every=kill_at)

        def die(r, info, kill_at=kill_at):
            if r + 1 == kill_at:
                raise Killed

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            simulation_for(ckcfg, device="cuda").run(hooks=[die])
            fail(f"{preset}: the kill hook did not fire")
        except Killed:
            pass
        t1 = time.perf_counter()
        # a copy of the killed leg's checkpoints for the fresh-process resume
        shutil.copytree(ckcfg.ckpt_dir, ckcfg.ckpt_dir + "_cli")
        sim, seen = simulation_for(ckcfg, device="cuda"), []
        res = sim.run(hooks=[lambda r, info: seen.append(r)])
        t2 = time.perf_counter()
        counts = ops.launch_counts()
        legs_counts[preset] = counts
        a, b = sim.state, full_sim.state
        params_eq = all(bits_equal(a.params[n], b.params[n])
                        for n in b.params)
        resid_eq = (sorted(a.residuals) == sorted(b.residuals)
                    and all(bits_equal(a.residuals[c][n], b.residuals[c][n])
                            for c in b.residuals for n in b.params))
        ring_eq = (not hasattr(sim, "versions")
                   or (len(sim.versions) == len(full_sim.versions)
                       and all(bits_equal(v[n], w[n]) for v, w in
                               zip(sim.versions, full_sim.versions)
                               for n in w)))
        ledger_eq = res.ledger.entries == full.ledger.entries
        print(f"[resume] {preset} on {kind}: killed after round {kill_at} "
              f"({t1 - t0:.3f} s), resumed rounds {seen[0] + 1}-{seen[-1] + 1} "
              f"({t2 - t1:.3f} s); against the uninterrupted run: ledger "
              f"entries equal={ledger_eq} accuracies equal="
              f"{res.accuracies == full.accuracies} losses equal="
              f"{res.losses == full.losses} params bit-equal={params_eq} "
              f"residuals bit-equal={resid_eq} ring bit-equal={ring_eq} "
              f"launches over both legs={counts}", flush=True)
        check(seen == list(range(kill_at, cfg.rounds)),
              f"{preset} resumed at the wrong round: {seen}")
        check(ledger_eq and res.accuracies == full.accuracies
              and res.losses == full.losses,
              f"{preset}: the resumed run's ledger, accuracies or losses "
              "differ from the uninterrupted run")
        check(params_eq and resid_eq and ring_eq,
              f"{preset}: the resumed run's params, residuals or ring "
              "differ from the uninterrupted run")
        check(counts["stream_scatter_add"] > 0,
              f"{preset}'s legs never launched the scatter")
        if cfg.sa.enabled:
            check(counts["pair_mask_streams"] == cfg.rounds,
                  f"{preset}'s legs launched pair_mask_streams "
                  f"{counts['pair_mask_streams']} times, expected one a "
                  f"round ({cfg.rounds})")
        resume_in_fresh_process(preset, kind, ckcfg.ckpt_dir + "_cli",
                                kill_at, full_sim, full)

    vgg16_resume_leg(kind)

    # one VGG16 checkpoint: params and 10 clients' residuals
    device = torch.device("cuda")
    tree = vgg16_tree(device)
    d = str(SMOKE_DIR / "vgg16")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save(d, 1, tree)
    t1 = time.perf_counter()
    back = checkpoint.restore(d, 1, like=tree)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = (all(bits_equal(back["params"][n], tree["params"][n])
                for n in tree["params"])
            and all(bits_equal(back["residuals"][c][n],
                               tree["residuals"][c][n])
                    for c in tree["residuals"] for n in tree["params"]))
    n_params = sum(p.numel() for p in tree["params"].values())
    print(f"[resume] cifar_vgg16 checkpoint on {kind}: {n_params} params + "
          f"{len(tree['residuals'])} clients' residuals, "
          f"{os.path.getsize(path) / 1e6:.1f} MB on disk: save "
          f"{(t1 - t0) * 1e3:.1f} ms, restore {(t2 - t1) * 1e3:.1f} ms, "
          f"bit-equal={same}", flush=True)
    check(same, "the VGG16 checkpoint did not restore bit-equal")
    del tree, back
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return legs_counts


# ------------------------------------------------------ phase 13: serve
SERVE_PRESET = "table2"   # the full Table 2 protocol, 28 rounds
SERVE_QPS = 1000          # offered load while it trains (open loop)
SERVE_MIN_TRAINING = 200  # requests served before training must end
BUSY_MATMULS = 120        # 8192^3 f32 products, ~20 ms each on an H100


def serve_phase(kind: str) -> dict:
    """``python -m repro_torch.serving --preset table2 --qps 1000`` through
    ``main()`` on the card, then one VGG16 publish staged through
    the watcher while the default stream is busy. Returns the CLI run's
    launch counts."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from repro_torch import checkpoint, serving
    from repro_torch.kernels import ops
    from repro_torch.models.paper_models import build_model
    from repro_torch.serving.__main__ import main as serve_main
    from repro_torch.sim import presets

    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    out = SMOKE_DIR / "serve.json"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = serve_main(["--preset", SERVE_PRESET, "--qps", str(SERVE_QPS),
                         "--publish-dir", str(SMOKE_DIR / "pub"),
                         "--out", str(out)])
    counts = ops.launch_counts()
    for line in text.getvalue().splitlines():
        print(f"[serve] {line}", flush=True)
    check(rc == 0, f"python -m repro_torch.serving exited {rc}")
    trained = re.search(r"trained (\d+) rounds in ([\d.]+) s .* (\d+) of "
                        r"them before training ended", text.getvalue())
    check(trained is not None, "the serve CLI printed no training window")
    train_s, in_training = float(trained.group(2)), int(trained.group(3))
    rounds = presets.get(SERVE_PRESET).rounds
    doc = serving.load_metrics(str(out))
    req, lat, sw, st = (doc["requests"], doc["latency_us"], doc["swaps"],
                        doc["staleness"])
    print(f"[serve] {SERVE_PRESET} at {SERVE_QPS} qps on {kind}: served "
          f"{req['served']} of {req['submitted']} ({in_training} while "
          f"{rounds} rounds trained in {train_s:.3f} s; {req['errors']} "
          f"errors), latency p50 "
          f"{lat['p50']:.1f} us p99 {lat['p99']:.1f} us, swaps "
          f"{sw['count']} at steps {sw['steps']} (pause p50 "
          f"{sw['pause_us']['p50']:.2f} us max {sw['pause_us']['max']:.2f} "
          f"us), staleness mean {st['mean']:.3f} max {st['max']} over "
          f"{st['samples']} batches, launches={counts}", flush=True)
    check(serving.validate_metrics(doc) == [], "invalid serve document")
    check(req["errors"] == 0, f"{req['errors']} errored requests")
    check(sw["count"] >= 1, "no hot swap happened")
    check(in_training >= SERVE_MIN_TRAINING,
          f"only {in_training} requests were served while training ran")
    check(sw["steps"][-1] == rounds,
          f"the server settled on step {sw['steps'][-1]}, not the final "
          f"published step {rounds}")
    check(counts["stream_scatter_add"] > 0
          and counts["pair_mask_streams"] == rounds,
          f"the serve loop's training launched {counts}")

    # one VGG16 publish, staged through the watcher on its own stream while
    # the default stream holds queued work, then swapped between batches
    device = torch.device("cuda")
    vgg = build_model("cifar_vgg16")
    old = vgg16_tree(device, n_clients=0)["params"]
    new = {n: p.detach().to(device) for n, p in build_model("cifar_vgg16")
           .init_(torch.Generator().manual_seed(7)).params().items()}
    pub = str(SMOKE_DIR / "vgg16_pub")
    checkpoint.publish(pub, 1, new)
    metrics = serving.ServingMetrics()
    buffers = serving.WeightBuffers(old, step=0)
    watcher = serving.CheckpointWatcher(pub, old, buffers, metrics=metrics)
    server = serving.InferenceServer(serving.ClassifierAdapter(vgg, 8),
                                     watcher=watcher, metrics=metrics)
    x = np.random.RandomState(0).randn(*vgg.input_shape).astype(np.float32)
    busy = torch.randn(8192, 8192, device=device)
    torch.cuda.synchronize()
    b0 = torch.cuda.Event(enable_timing=True)
    b1 = torch.cuda.Event(enable_timing=True)
    b0.record()
    for _ in range(BUSY_MATMULS):             # queued on the default stream
        busy = torch.tanh(busy @ busy)
    b1.record()
    t0 = time.perf_counter()
    staged = watcher.poll_once()
    t_stage = time.perf_counter() - t0
    busy_left = not b1.query()                # still running at staging's end
    torch.cuda.synchronize()
    busy_ms = b0.elapsed_time(b1)
    ticket = server.submit(x)
    server.step(block=True)
    after = ticket.wait(60.0)
    cold = serving.InferenceServer(serving.ClassifierAdapter(vgg, 8),
                                   checkpoint.restore(pub, 1, like=old))
    ticket = cold.submit(x)
    cold.step(block=True)
    same = after.tobytes() == ticket.wait(60.0).tobytes()
    n_params = sum(p.numel() for p in new.values())
    stage = watcher.last_stage
    print(f"[serve] cifar_vgg16 publish on {kind}: {n_params} params "
          f"({4 * n_params / 1e6:.1f} MB) staged as step {staged}: host load "
          f"{stage['load_ms']:.2f} ms, side-stream copy {stage['copy_ms']:.2f} "
          f"ms (staging {t_stage * 1e3:.2f} ms while {busy_ms:.1f} ms of "
          f"work sat queued on the default stream, still running at its "
          f"end={busy_left}), swap pause {metrics.swap_pauses_us[-1]:.2f} "
          f"us, logits after the swap bit-equal to a cold restore={same}",
          flush=True)
    check(staged == 1 and buffers.active_step == 1,
          "the VGG16 publish was not staged and swapped in")
    check(busy_left, "the staging ended only after the default stream's "
          "queued work: it waited on the device, not on its own stream")
    check(same, "logits after the VGG16 swap differ from a cold restore")
    del busy, old, new, buffers, watcher, server, cold
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    return counts


# ---------------------------------------------------- phase 14: sharded
# the reference's sharded == serial parity configuration
# (tests/test_client_sharded_round.py): mnist_mlp at full width, 12 clients,
# cohort 6, 3 rounds, dropout 0.4, weights by data count, mask ratio 0.02
PARITY_MESHES = (2, 3, 6)
SHARDED_PRESETS = (("tree_quick", 3), ("dp_quick", 2))
INT8_SHARDS = 5            # codec_sweep_quick's int8 arm, cohort 5
VGG_SHARDS = 5             # table2 protocol, cohort 5: one client a shard


def parity_config():
    from repro_torch.core.types import SecureAggConfig, THGSConfig
    from repro_torch.sim.config import SimConfig

    return SimConfig(
        name="parity", model="mnist_mlp", dataset="mnist", rounds=3,
        n_clients=12, clients_per_round=6, n_train=600, n_test=200,
        local_steps=2, local_batch=16, eval_every=1,
        thgs=THGSConfig(s0=0.05, alpha=0.9, s_min=0.01),
        sa=SecureAggConfig(mask_ratio=0.02, seed=3), dropout_rate=0.4,
        weight_by_data_count=True, seed=1, shard_clients="off")


def row_launch_rows(device) -> list:
    """The pair-mask kernel's row launch (a shard's rows of the seed
    matrix, ``rows = C_loc < peers = C``, no mirror) at mnist_mlp's 4 leaves
    (6 clients, shards of 2 and 3) and VGG16's 54 (5 clients, one a shard):
    every shard's launch bit-equal to the plain version and to its rows of
    the mirrored round launch; the raw launch of one shard (CUDA graph)
    beside the wrapper, the plain version and the bound."""
    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import mask_prng, ref

    out = []
    for model, C, c_locs in (("mnist_mlp", 6, (2, 3)),
                             ("cifar_vgg16", 5, (1,))):
        seeds, signs, _, _, leaves = model_round(model, C)
        sd, gd = se.round_matrices(device, seeds, signs)
        whole = se.mask_streams_round(sd, gd, leaves, p=-1.0, q=2.0)
        for c_loc in c_locs:
            tag = f"{model} row launch ({len(leaves)} leaves, C_loc={c_loc} " \
                  f"of C={C})"
            before = mask_prng.launches
            err = 0.0
            for i0 in range(0, C, c_loc):
                sr, gr = sd[i0:i0 + c_loc], gd[i0:i0 + c_loc]
                got = se.mask_streams_rows_round(sr, gr, leaves, p=-1.0,
                                                 q=2.0)
                plain = ref.pair_mask_segments_ref(sr, gr, leaves)
                for leaf, (i, v), (pi, pv), (wi, wv) in zip(
                        leaves, got, plain, whole):
                    check(bits_equal(i, pi) and bits_equal(v, pv),
                          f"{tag}: shard at {i0} != plain at leaf {leaf[3]}")
                    check(bits_equal(i, wi[i0:i0 + c_loc])
                          and bits_equal(v, wv[i0:i0 + c_loc]),
                          f"{tag}: shard at {i0} != its rows of the mirrored "
                          f"round launch at leaf {leaf[3]}")
                    err = max(err, (v - pv).abs().max().item())
            torch.cuda.synchronize()
            n_launch = mask_prng.launches - before
            check(n_launch == C // c_loc,
                  f"{tag}: {n_launch} launches for {C // c_loc} shards")
            sr, gr = sd[:c_loc], gd[:c_loc]
            outs = se.mask_streams_rows_round(sr, gr, leaves, p=-1.0, q=2.0)
            launch = raw_mask_launch(
                sr, gr, c_loc, C, 0, None,
                [(i, v, nb, k, m, leaf) for (i, v), (nb, k, m, leaf)
                 in zip(outs, leaves)])
            ms = graph_ms(launch)
            wrapper_ms = events_ms(lambda: se.mask_streams_rows_round(
                sr, gr, leaves, p=-1.0, q=2.0))
            plain_ms = events_ms(lambda: ref.pair_mask_segments_ref(
                sr, gr, leaves), reps=3, inner=3)
            slots = sum(c_loc * C * nb * k for nb, k, _, _ in leaves)
            bound_ms, bound_by = bound(8 * slots + 8 * c_loc * C,
                                       MASK_OPS_PER_SLOT * slots)
            out.append(dict(shape=tag, n=slots, ms=ms, wrapper_ms=wrapper_ms,
                            plain_ms=plain_ms, library_ms=None,
                            bound_ms=bound_ms, bound_by=bound_by,
                            max_abs_err=err))
            print(f"[sharded] pair_mask_streams {tag}: {C // c_loc} shard "
                  f"launches, each bit-equal to plain and to its rows of the "
                  f"mirrored launch=yes; one shard: slots={slots} "
                  f"ms={ms:.6f} wrapper_ms={wrapper_ms:.6f} "
                  f"plain_ms={plain_ms:.6f} bound_ms={bound_ms:.6f}",
                  flush=True)
    return out


def states_equal(a, b) -> tuple[bool, bool]:
    params = all(bits_equal(a.params[n], b.params[n]) for n in b.params)
    resid = (sorted(a.residuals) == sorted(b.residuals)
             and all(bits_equal(a.residuals[c][n], b.residuals[c][n])
                     for c in b.residuals for n in b.params))
    return params, resid


def timed_run(cfg, shards: int, device, log: list | None = None):
    """One run of ``cfg`` on the card, serial (0) or over ``shards``
    shards of ``device``; counts reset before, and each round's launches
    read by a round hook; ``log`` gets each leaf's (name, updates).
    Returns (sim, result, per-round launches)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import ClientsMesh
    from repro_torch.sim.engine import Simulation

    sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                     device="cuda")
    if shards:
        sim.mesh = ClientsMesh((device,) * shards)
    if log is not None:
        sim.leaf_hook = lambda leaf_id, name, info: log.append(
            (name, info["updates"].clone()))
    per_round, prev = [], {}

    def round_hook(r, info):
        now = ops.launch_counts()
        per_round.append((r, list(info["dropped"]),
                          {n: now[n] - prev.get(n, 0) for n in now}))
        prev.update(now)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run(resume=False, hooks=[round_hook])
    return sim, res, per_round


def leafwise_check(cfg, shards: int, device, log: list | None = None
                   ) -> dict:
    """The serial run with a leaf hook that feeds each leaf's encode inputs
    (the serial round's deltas and residuals, its masks' seeds and its
    dropout) to ``encode_decode_leaf_sharded`` over ``shards`` shards of
    ``device``, and holds the decoded sum and the new residuals bit-equal to
    the serial round's. Returns the leaves checked, those that differ, the
    run's final state (a second serial run) and the bytes the sharded round's gathers move a round (the stream or its
    packed words, and the residuals), summed over the run. ``log`` gets
    each leaf's (round, name, updates)."""
    import torch

    from repro_torch.core import codecs
    from repro_torch.core import streams as se
    from repro_torch.kernels import ref
    from repro_torch.launch.mesh import ClientsMesh
    from repro_torch.sim.engine import Simulation

    mesh = ClientsMesh((device,) * shards)
    sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                     device="cuda")
    out = {"leaves": 0, "differ": [], "stream_bytes": 0, "residual_bytes": 0}

    def hook(leaf_id, name, info):
        size, C = info["size"], info["updates"].shape[0]
        dropped = bool(info["dropped"])
        dense, nr, st = se.encode_decode_leaf_sharded(
            mesh, info["updates"], info["residuals"], k=info["k"], nb=1,
            m=size, size=size, pair_seeds=info["pair_seeds"],
            pair_signs=info["pair_signs"],
            recovery_seeds=info["recovery_seeds"],
            alive=info["alive"] if dropped else None,
            k_mask=info["k_mask"], mask_p=cfg.sa.p, mask_q=cfg.sa.q,
            leaf_id=leaf_id, weights=info["weights"], codec=info["codec"],
            topology=cfg.topology, tree_groups=cfg.tree_groups,
            dp_sigma=info["dp_sigma"], dp_seeds=info["dp_seeds"],
            dp_support_seed=info["dp_support_seed"])
        same = (bits_equal(dense, info["dense"])
                and bits_equal(nr, info["new_residuals"])
                and bits_equal(st.indices, info["streams"].indices)
                and bits_equal(st.values, info["streams"].values))
        if log is not None:
            log.append((name, info["updates"].clone()))
        out["leaves"] += 1
        if not same:
            out["differ"].append((out["leaves"] - 1, name))
        if info["codec"] == "f32":
            st = info["streams"]
            out["stream_bytes"] += st.indices.nbytes + st.values.nbytes
        else:
            k = min(info["k"], size)
            words = (ref.packed_words(k, codecs.index_width(size))
                     + ref.packed_words(k, codecs.value_bits(info["codec"])))
            out["stream_bytes"] += 4 * C * (words + 1)
        out["residual_bytes"] += info["new_residuals"].nbytes

    sim.leaf_hook = hook
    sim.run(resume=False)
    torch.cuda.synchronize()
    out["state"] = sim.state
    return out


def first_divergence(cfg, shards: int, device) -> str:
    """Where a sharded run first leaves the serial one: each leaf's local
    SGD deltas, then its decoded sum, compared round by round."""
    from repro_torch.launch.mesh import ClientsMesh
    from repro_torch.sim.engine import Simulation

    logs = []
    for mesh in (None, ClientsMesh((device,) * shards)):
        sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                         device="cuda")
        sim.mesh = mesh
        log = []
        sim.leaf_hook = lambda leaf_id, name, info, log=log: log.append(
            (name, info["updates"].clone(), info["dense"].clone()))
        sim.run(resume=False)
        logs.append(log)
    n_leaves = len(Simulation(cfg.replace(out_json=None), device="cuda")
                   .model.leaf_names())
    for i, ((name, u0, d0), (_, u1, d1)) in enumerate(zip(*logs)):
        r = i // n_leaves
        if not bits_equal(u0, u1):
            return (f"round {r} leaf {name}: the local SGD deltas differ "
                    f"(max abs {(u0 - u1).abs().max().item():.3e})")
        if not bits_equal(d0, d1):
            return (f"round {r} leaf {name}: equal deltas, the decoded sum "
                    f"differs (max abs {(d0 - d1).abs().max().item():.3e})")
    return "no leaf differs"


def compare_sharded(tag: str, cfg, serial, shards: int, device) -> dict:
    """A sharded run of ``cfg`` against the serial one (``serial`` = (sim,
    result, per-round launches)): params, every client's residuals, ledger
    entries and accuracies bit-equal; where they are not, the first round
    and leaf that differ are named and the phase fails. Returns the row
    printed."""
    sim0, res0, _ = serial
    sim, res, per_round = timed_run(cfg, shards, device)
    row = run_row(tag, shards, cfg, (sim, res, per_round), serial)
    if not row["exact"]:
        fail(f"{tag} over {shards} shards is not bit-equal: first "
             f"divergence {first_divergence(cfg, shards, device)}")
    return row


def run_row(tag: str, shards: int, cfg, run, serial) -> dict:
    """Hold one run against another (params, residuals, ledger entries,
    accuracies, losses, bit for bit) and print the comparison beside both
    runs' round times and the sharded run's launches a round."""
    (sim, res, per_round), (sim0, res0, _) = run, serial
    params_eq, resid_eq = states_equal(sim.state, sim0.state)
    ledger_eq = res.ledger.entries == res0.ledger.entries
    accs_eq = res.accuracies == res0.accuracies
    row = dict(tag=tag, shards=shards,
               exact=params_eq and resid_eq and ledger_eq and accs_eq,
               params_eq=params_eq, resid_eq=resid_eq, ledger_eq=ledger_eq,
               accs_eq=accs_eq, losses_eq=res.losses == res0.losses,
               round_s=res.wall_s / cfg.rounds,
               serial_round_s=res0.wall_s / cfg.rounds,
               per_round=per_round)
    print(f"[sharded] {tag} over {shards} shards of one card: params "
          f"bit-equal={params_eq} residuals bit-equal={resid_eq} ledger "
          f"entries equal={ledger_eq} accuracies equal={accs_eq} losses "
          f"equal={row['losses_eq']}; round {row['round_s']:.4f} s (serial "
          f"{row['serial_round_s']:.4f} s); launches a round "
          f"{[(r, d, {n: c for n, c in x.items() if c}) for r, d, x in per_round]}",
          flush=True)
    return row


def round_inputs(cfg, device):
    """The first round's inputs of ``cfg``'s engine on the card: (params,
    stacked client batches, loss, FedConfig)."""
    import torch

    from repro_torch.sim.engine import Simulation

    sim = Simulation(cfg.replace(out_json=None, shard_clients="off"),
                     device="cuda")
    batches = sim._batches_for(0, sim.sampler.cohort_for(0))
    parts = sorted(batches)
    stacked = tuple(torch.stack([batches[c][i] for c in parts])
                    for i in range(len(batches[parts[0]])))
    return sim._fresh_state().params, stacked, sim.loss_fn, sim.fed


def plain_ops(fn, *args):
    """``paper_models.per_client`` as the port ran it before: ``fn``
    itself, which ``vmap`` batches (a grouped convolution, vmapped BN)."""
    return fn(*args)


def formula_conv_bn(h, w, b, scale, bias, padding: int, eps: float = 1e-5):
    """VGG16's convolution and batch norm as the port wrote them before:
    the BN formula's ops (mean, biased variance, rsqrt, affine map)."""
    import torch

    from repro_torch.models import paper_models as pm

    h = pm._conv2d(h, w, b, padding)
    mu = h.mean(dim=(0, 2, 3), keepdim=True)
    var = h.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    return ((h - mu) * torch.rsqrt(var + eps) * scale[None, :, None, None]
            + bias[None, :, None, None])


PORT_VARIANT = "per-client ops, autograd over vmap (the port)"
# name: (the ops as before: plain_ops and the BN formula; gradient by
# torch.func.grad inside vmap)
PROBE_VARIANTS = {
    "plain ops, torch.func.grad inside vmap (before)": (True, True),
    "per-client ops, torch.func.grad inside vmap": (False, True),
    PORT_VARIANT: (False, False),
}


def client_count_probe(cfg, device) -> dict:
    """Client 0's first local SGD step at ``cfg``'s first round, in one
    vmapped call with 5 clients against 2 and against 1 (its row
    duplicated): the largest difference of each VGG16 layer's output
    (convolution, BN and relu) and of each gradient leaf, and the first of
    each that differs, under each of ``PROBE_VARIANTS``: the ops as the
    port ran them before (``plain_ops``) or per client, the gradient
    taken by ``torch.func.grad`` inside ``vmap`` (as before) or by
    autograd over the vmapped forward (``fedavg``'s path for such a
    model). Prints a line a variant and count; returns {(variant, C):
    (forward max, first layer, gradient max, first leaf)}."""
    import functools

    import torch
    import torch.nn.functional as F

    from repro_torch.models import paper_models as pm

    params, batches, loss_fn, _ = round_inputs(cfg, device)
    x, y = batches[0][:, 0], batches[1][:, 0]       # the first local step

    def layers(p, x):
        h, i, out = pm._nchw(x), 0, []
        for v in pm._VGG_CFG:
            if v == "M":
                h = F.max_pool2d(h, 2)
                continue
            h = torch.relu(pm.per_client(
                functools.partial(pm._conv_bn, padding=1), h, p[f"c{i}.w"],
                p[f"c{i}.b"], p[f"bn{i}.scale"], p[f"bn{i}.bias"]))
            out.append((f"c{i}+bn{i}+relu", h))
            i += 1
        return dict(out)

    def client0(C, grad_inside):
        xs, ys = x[:C], y[:C]
        if C == 1:
            xs, ys = torch.cat([xs, xs]), torch.cat([ys, ys])
        ps = {n: torch.stack([v] * xs.shape[0]) for n, v in params.items()}
        fwd = torch.func.vmap(layers)(ps, xs)
        if grad_inside:
            grads = torch.func.vmap(torch.func.grad(loss_fn))(ps, (xs, ys))
        else:
            leaves = {n: v.requires_grad_() for n, v in ps.items()}
            loss = torch.func.vmap(loss_fn)(leaves, (xs, ys))
            grads = dict(zip(leaves, torch.autograd.grad(
                loss.sum(), list(leaves.values()))))
        return ({n: t[0].detach() for n, t in fwd.items()},
                {n: t[0] for n, t in grads.items()})

    def gaps(a, b):
        d = {n: (a[n] - b[n]).abs().max().item() for n in a}
        return max(d.values()), next((n for n in d if d[n]), "none")

    out = {}
    for name, (before, grad_inside) in PROBE_VARIANTS.items():
        real = pm.per_client, pm._conv_bn
        if before:
            pm.per_client, pm._conv_bn = plain_ops, formula_conv_bn
        try:
            f5, g5 = client0(5, grad_inside)
            for C in (2, 1):
                f, g = client0(C, grad_inside)
                out[name, C] = gaps(f, f5) + gaps(g, g5)
                fm, fl, gm, gl = out[name, C]
                print(f"[sharded] probe, {name}: client 0 of C={C}"
                      f"{' (row duplicated)' if C == 1 else ''} against C=5 "
                      f"(VGG16, first round, first step): forward max abs "
                      f"{fm:.6e}, first layer apart {fl}; gradient max abs "
                      f"{gm:.6e}, first leaf apart {gl}", flush=True)
        finally:
            pm.per_client, pm._conv_bn = real
    del params, batches
    torch.cuda.empty_cache()
    return out


def pad_readings(tag: str, cfg, device, reps: int) -> dict:
    """The one-client shard's local SGD at ``cfg``'s first round, over one
    shard a client of ``device``: with its duplicated row (``pad_one``, the
    default) and without, each held against the serial cohort's deltas (bit
    for bit or not, and the largest difference) and timed on the host clock
    (median of ``reps``), beside the serial cohort's call (``serial_ms``)."""
    import torch

    from repro_torch.core import fedavg
    from repro_torch.core import streams as se
    from repro_torch.launch.mesh import ClientsMesh

    params, batches, loss_fn, fed = round_inputs(cfg, device)
    C = batches[0].shape[0]
    mesh = ClientsMesh((device,) * C)

    def serial():
        return fedavg.batched_client_update(params, batches, loss_fn,
                                            fed.local_steps, fed.local_lr)[0]

    def median_ms(fn):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(ts)

    whole = serial()
    out = {"serial_ms": median_ms(serial)}
    for pad in (True, False):
        def sgd():
            return fedavg.batched_client_update_sharded(
                mesh, params, batches, loss_fn, fed.local_steps,
                fed.local_lr, pad_one=pad)[0]

        got = se.all_gather_round(sgd(), device)
        out[pad] = dict(
            bit_equal=all(bits_equal(got[n], whole[n]) for n in whole),
            max_abs=max((got[n] - whole[n]).abs().max().item()
                        for n in whole),
            ms=median_ms(sgd))
    print(f"[sharded] {tag}: local SGD of {C} one-client shards, first "
          f"round: with the duplicated row bit-equal to the cohort's="
          f"{out[True]['bit_equal']} (max abs {out[True]['max_abs']:.6e}) "
          f"{out[True]['ms']:.3f} ms; without it bit-equal="
          f"{out[False]['bit_equal']} (max abs {out[False]['max_abs']:.6e}) "
          f"{out[False]['ms']:.3f} ms; the serial cohort's call "
          f"{out['serial_ms']:.3f} ms (median of {reps})", flush=True)
    return out


def mlp_program_check(tag: str, cfg, device) -> None:
    """``cfg``'s first-round local SGD (an MLP, no per-client op) through
    ``fedavg.batched_client_update`` (autograd over the vmapped forward)
    bit-equal to ``torch.func.grad_and_value`` inside ``vmap``, the
    program before per-client ops."""
    import torch

    from repro_torch.core import fedavg

    params, batches, loss_fn, fed = round_inputs(cfg, device)
    C = batches[0].shape[0]
    stacked = {n: torch.stack([p] * C) for n, p in params.items()}
    got, got_loss = fedavg.batched_client_update(
        params, batches, loss_fn, fed.local_steps, fed.local_lr)
    want, want_loss = torch.func.vmap(
        lambda p, *b: fedavg._client_update(p, b, loss_fn, fed.local_steps,
                                            fed.local_lr),
        randomness="error")(stacked, *batches)
    same = (all(bits_equal(got[n], want[n]) for n in want)
            and bits_equal(got_loss, want_loss))
    print(f"[sharded] {tag}: local SGD of {C} clients (autograd over the "
          f"vmapped forward) bit-equal to torch.func.grad_and_value inside "
          f"vmap={same}", flush=True)
    check(same, f"{tag}: the local SGD differs from torch.func.grad_and_value "
          "inside vmap")


def vgg16_sharded(cfg, shards: int, device) -> dict:
    """VGG16 over ``shards`` one-client shards under deterministic cuDNN
    (module docstring, phase 14): the sharded encode/decode fed the serial
    run's deltas leaf by leaf (a second serial run, bit-equal to the
    first), then the sharded run against the plain serial run bit for bit.
    Returns the row printed."""
    import torch

    serial = timed_run(cfg, 0, device)
    lw = leafwise_check(cfg, shards, device)
    print(f"[sharded] cifar_vgg16: the sharded encode/decode fed the "
          f"serial run's deltas over {shards} shards: {lw['leaves']} "
          f"leaves, bit-equal except {lw['differ']}; per round the "
          f"gather moves {lw['stream_bytes'] / cfg.rounds:.0f} stream "
          f"bytes and the residual return "
          f"{lw['residual_bytes'] / cfg.rounds:.0f} bytes", flush=True)
    check(not lw["differ"], f"VGG16: the sharded encode/decode fed the "
          f"serial deltas differs at leaves {lw['differ']}")
    check(states_equal(lw["state"], serial[0].state) == (True, True),
          "VGG16: two serial runs under deterministic cuDNN differ")
    row = compare_sharded("cifar_vgg16 table2", cfg, serial, shards, device)
    del serial, lw
    torch.cuda.empty_cache()
    return row


def sharded_phase(kind: str, card: str, device) -> tuple[dict, list]:
    """Phase 14 (module docstring). Returns the launches of the parity
    runs over 2, 3 and 6 shards and of the int8 arm's sharded run (the
    sharded main path), and the row launch's kernel rows."""
    import torch

    from repro_torch.sim import presets

    t_phase = time.perf_counter()
    rows = row_launch_rows(device)
    counts = {}

    def add(per_round):
        for _, _, x in per_round:
            for n, c in x.items():
                counts[n] = counts.get(n, 0) + c

    # the reference's parity config over 2, 3 and 6 shards
    cfg = parity_config()
    n_leaves = 4
    timed_run(cfg.replace(rounds=1), 0, device)          # warm-up
    serial = timed_run(cfg, 0, device)
    lw = leafwise_check(cfg, 2, device)
    check(not lw["differ"], f"parity: the sharded encode/decode fed the "
          f"serial deltas differs at leaves {lw['differ']}")
    dropout_rounds = sum(bool(d) for _, d, _ in serial[2])
    check(dropout_rounds >= 1, "the parity config dropped no client")
    results = []
    for shards in PARITY_MESHES:
        row = compare_sharded("parity (mnist_mlp, cohort 6)", cfg, serial,
                              shards, device)
        for r, dropped, x in row["per_round"]:
            want = shards + (1 if dropped else 0)
            check(x["pair_mask_streams"] == want,
                  f"parity over {shards} shards, round {r}: "
                  f"{x['pair_mask_streams']} pair-mask launches, expected "
                  f"{want}")
            check(x["stream_scatter_add"] == n_leaves,
                  f"parity over {shards} shards, round {r}: "
                  f"{x['stream_scatter_add']} scatter launches, expected "
                  f"{n_leaves}")
        add(row["per_round"])
        results.append(row)
    print(f"[sharded] parity: {dropout_rounds} dropout round(s); per "
          f"round the gather moves {lw['stream_bytes'] / cfg.rounds:.0f} "
          f"stream bytes and the residual return "
          f"{lw['residual_bytes'] / cfg.rounds:.0f} bytes (each copied "
          f"device to device on {card})", flush=True)

    # tree_quick over 3 shards, dp_quick over 2
    for preset, shards in SHARDED_PRESETS:
        cfg = presets.get(preset)
        serial = timed_run(cfg, 0, device)
        lw = leafwise_check(cfg, shards, device)
        check(not lw["differ"], f"{preset}: the sharded encode/decode fed "
              f"the serial deltas differs at leaves {lw['differ']}")
        row = compare_sharded(preset, cfg, serial, shards, device)
        for r, dropped, x in row["per_round"]:
            want = shards + (1 if dropped else 0)
            check(x["pair_mask_streams"] == want,
                  f"{preset} over {shards} shards, round {r}: "
                  f"{x['pair_mask_streams']} pair-mask launches, expected "
                  f"{want}")
        results.append(row)

    # codec_sweep_quick's int8 arm over 5 shards
    cfg = presets.sweep_configs("codec_sweep_quick")["int8"]
    serial = timed_run(cfg, 0, device)
    lw = leafwise_check(cfg, INT8_SHARDS, device)
    check(not lw["differ"], f"int8: the sharded encode/decode fed the "
          f"serial deltas differs at leaves {lw['differ']}")
    row = compare_sharded("codec_sweep_quick int8", cfg, serial, INT8_SHARDS,
                          device)
    for r, _, x in row["per_round"]:
        check(x["bitpack_rows"] == INT8_SHARDS * n_leaves
              and x["bitunpack_rows"] == n_leaves,
              f"int8 over {INT8_SHARDS} shards, round {r}: "
              f"{x['bitpack_rows']} pack and {x['bitunpack_rows']} unpack "
              f"launches, expected {INT8_SHARDS * n_leaves} and {n_leaves}")
    add(row["per_round"])
    results.append(row)
    print(f"[sharded] int8: per round the gather moves "
          f"{lw['stream_bytes'] / cfg.rounds:.0f} bytes of packed words and "
          f"scales and the residual return "
          f"{lw['residual_bytes'] / cfg.rounds:.0f} bytes", flush=True)

    pad = pad_readings("codec_sweep_quick int8", cfg, device, reps=7)
    check(pad[True]["bit_equal"], "int8: the one-client shards' local SGD "
          "with the duplicated row is not bit-equal to the cohort's")
    mlp_program_check("codec_sweep_quick int8", cfg, device)

    # VGG16 under the table2 protocol, 2 rounds over 5 shards
    cfg = vgg16_table2()
    probe = client_count_probe(cfg, device)
    check(all(probe[PORT_VARIANT, C] == (0.0, "none", 0.0, "none")
              for C in (2, 1)),
          "VGG16: client 0's forward or gradient in a call of 2 clients, or "
          "of 1 with its row duplicated, differs from its own in a call of "
          "5")
    pad = pad_readings("cifar_vgg16 table2 (deterministic cuDNN)", cfg,
                       device, reps=3)
    check(pad[True]["bit_equal"], "VGG16: the one-client shards' local SGD "
          "with the duplicated row is not bit-equal to the cohort's")
    row = vgg16_sharded(cfg, VGG_SHARDS, device)
    for r, dropped, x in row["per_round"]:
        check(x["pair_mask_streams"] == VGG_SHARDS,
              f"VGG16 round {r}: {x['pair_mask_streams']} pair-mask "
              f"launches, expected {VGG_SHARDS}")
    results.append(row)
    torch.cuda.empty_cache()
    print(f"[sharded] phase 14 took {time.perf_counter() - t_phase:.1f} s "
          f"({card}): " + "; ".join(
              f"{r['tag']} x{r['shards']}: round {r['round_s']:.4f} s vs "
              f"serial {r['serial_round_s']:.4f} s exact={r['exact']}"
              for r in results), flush=True)
    return counts, rows


# ------------------------------------------------------- phase 15: bench
BENCH_KERNELS = ("stream_scatter_add", "pair_mask_streams", "bitpack_rows",
                 "bitunpack_rows", "flash_attention")
# the single-device rows of the reference's BENCH_round.json
BENCH_ROUND_NAMES = ["round/model_size_c8", "round/serial_c8",
                     "round/serial_dropout_c8", "round/sharded_c8"]


def bench_names() -> dict:
    """Each suite's expected ``--quick`` entry names: the reference's
    committed quick names (``BENCH_<suite>.json``; for ``round`` its
    single-device rows)."""
    out = {"round": BENCH_ROUND_NAMES}
    for suite in ("agg", "cohort", "serve"):
        with open(ROOT / f"BENCH_{suite}.json") as f:
            out[suite] = [e["name"] for e in json.load(f)["entries"]]
    return out


# the agg suite's loop round (per-client means, summed client by client)
# against its batched round (one sum, then / C): the same slots added in
# another order. The limit is 2 times the reading that PERF.md section 6
# records for this script (2.980232e-08 on an H100, the same bits as the
# plain versions give on the CPU)
LOOP_BATCHED_ATOL = 6e-8


def bench_path_checks(device) -> None:
    """Phase 15's kernel and helper checks at the suites' ``--quick`` shapes,
    on the suites' own inputs (module docstring)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.bench import agg_bench, cohort_bench
    from repro_torch.core import codecs, streams
    from repro_torch.core.masks import client_masks, pair_mask
    from repro_torch.core.secure_agg import encode_leaf
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.mesh import default_tree_groups

    cpu = torch.device("cpu")
    size, C = agg_bench.QUICK_SIZE, agg_bench.QUICK_CLIENTS
    x = agg_bench.round_inputs(size, C, device)
    xc = agg_bench.round_inputs(size, C, cpu)
    sa, P, k, km, thgs = x["sa"], x["participants"], x["k"], x["k_mask"], \
        x["thgs"]

    def mask_eq(a, b) -> bool:
        return (bits_equal(a.indices.cpu(), b.indices)
                and bits_equal(a.values.cpu(), b.values))

    for a in P:
        for b in P:
            if a != b:
                check(mask_eq(pair_mask(sa, a, b, 0, 0, size, km,
                                        device=device),
                              pair_mask(sa, a, b, 0, 0, size, km,
                                        device=cpu)),
                      f"pair_mask({a}, {b}) on the card != on the CPU")
    for ci, c in enumerate(P):
        mg = client_masks(sa, c, P, 0, 0, size, km, device=device)
        mc = client_masks(sa, c, P, 0, 0, size, km, device=cpu)
        check(mask_eq(mg, mc), f"client_masks({c}) on the card != on the CPU")
        eg = encode_leaf(x["grads"][ci], x["residuals"][ci], k, thgs, mg)
        ec = encode_leaf(xc["grads"][ci], xc["residuals"][ci], k, thgs, mc)
        check(bits_equal(eg.stream.indices.cpu(), ec.stream.indices)
              and bits_equal(eg.stream.values.cpu(), ec.stream.values)
              and bits_equal(eg.residual.cpu(), ec.residual),
              f"encode_leaf of client {c} on the card != on the CPU")
    print(f"[bench] agg inputs (C={C}, m={size}, k={k}, k_mask={km}): "
          f"pair_mask x{C * (C - 1)}, client_masks and encode_leaf x{C} "
          f"bit-equal to the CPU's", flush=True)

    seeds = torch.arange(1, C * C + 1, dtype=torch.int64, device=device)
    signs = torch.ones((C * C,), dtype=torch.float32, device=device)
    got = ops.pair_mask_streams(seeds, signs, nb=1, k_mask=km, m=size,
                                p=sa.p, q=sa.q)
    plain = ref.pair_mask_stream_ref(seeds, signs, 1, km, size, p=sa.p,
                                     q=sa.q)
    check(all(bits_equal(g, w) for g, w in zip(got, plain)),
          f"the agg micro's {C * C}-pair mask launch != plain")

    loop = agg_bench._loop_round(x["grads"], x["residuals"], k, thgs, sa, P,
                                 size, device)
    loop_cpu = agg_bench._loop_round(xc["grads"], xc["residuals"], k, thgs,
                                     sa, P, size, cpu)
    st, _ = streams.encode_leaf_batch(
        x["grads"], x["residuals"], k=k, nb=1, m=size, size=size,
        pair_seeds=x["pair_seeds"], pair_signs=x["pair_signs"], k_mask=km,
        mask_p=sa.p, mask_q=sa.q, leaf_id=0)
    batched = streams.decode_leaf_batch(st, nb=1, m=size, size=size)
    gap = (loop - batched / C).abs().max().item()
    print(f"[bench] agg loop round: bit-equal to the CPU's="
          f"{bits_equal(loop.cpu(), loop_cpu)}; max |loop - batched / C| "
          f"{gap:.6e} (limit {LOOP_BATCHED_ATOL:.1e}, max |loop| "
          f"{loop.abs().max().item():.4f})", flush=True)
    check(bits_equal(loop.cpu(), loop_cpu),
          "the agg loop round on the card != on the CPU")
    check(gap <= LOOP_BATCHED_ATOL, f"the agg loop round is {gap:.3e} from "
          "the batched round's mean")

    csize, ck, _ = cohort_bench.leaf(quick=True)
    for n in cohort_bench.COHORTS:
        cs = cohort_bench.cohort_streams(n, csize, ck, device)
        plain = ref.stream_scatter_add_ref(cs.indices.reshape(-1),
                                           cs.values.reshape(-1), csize)
        splits = streams.tree_splits(csize, default_tree_groups(n))
        check(bits_equal(streams.decode_sum_blocks(cs, 1, csize), plain)
              and bits_equal(streams.decode_sum_tree(cs, 1, csize,
                                                     splits=splits), plain),
              f"cohort c{n}: the flat or tree decode != plain")
    print(f"[bench] cohort streams c{cohort_bench.COHORTS} ({ck} slots a "
          f"client into {csize}): flat and tree decodes bit-equal to plain",
          flush=True)

    rs = np.random.RandomState(21)
    for codec in ("int8", "int4", "1bit"):
        widths = [codecs.index_width(size), codecs.value_bits(codec)]
        fields = [pack_fields(rs, C, k, w, device).to(torch.int32)
                  for w in widths]
        words = ops.bitpack_segments(fields, widths=widths)
        back = ops.bitunpack_segments(words, ks=[k, k], widths=widths)
        check(all(bits_equal(g, w) for g, w in
                  zip(words, ref.bitpack_segments_ref(fields, widths)))
              and all(bits_equal(g, w) for g, w in
                      zip(back, ref.bitunpack_segments_ref(words, [k, k],
                                                           widths)))
              and all(bits_equal(g, u) for g, u in zip(back, fields)),
              f"the {codec} packs at {C}x{k} != plain or no round trip")
    print(f"[bench] codec packs at {C}x{k} (widths {codecs.index_width(size)}"
          f" + 8 / 4 / 1): bit-equal to plain, round trip exact", flush=True)

    cfg = configs.reduced(configs.get("yi_6b"))
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_model // cfg.n_heads
    q, kk, v, _ = flash_inputs(4, 16, 16, H, Hkv, hd, torch.float32, True,
                               None, None, 121, device)
    out = ops.flash_attention(q, kk, v, causal=True)
    plain = ref.flash_attention_ref(q, kk, v, causal=True)
    err = (out - plain).abs().max().item()
    print(f"[bench] flash f32 at the reduced Yi-6B prefill (B 4, T 16, H {H},"
          f" Hkv {Hkv}, hd {hd}): max abs err {err:.3e} (tolerance 2e-5)",
          flush=True)
    check(out.shape == q.shape and torch.allclose(out, plain, rtol=2e-5,
                                                  atol=2e-5),
          f"flash f32 at the reduced Yi-6B prefill off by {err:.3e}")


# the timed suites in a fresh process: ``main()`` of ``python -m
# repro_torch.bench --quick --out <argv[1]>``, then the launch counts as the
# last line
BENCH_SUITES_SCRIPT = """
import json, sys
from repro_torch.bench.__main__ import main
from repro_torch.kernels import ops
rc = main(["--quick", "--out", sys.argv[1]])
print(json.dumps(ops.launch_counts()))
sys.exit(rc)
"""


def bench_phase(kind: str, card: str) -> dict:
    """Phase 15 (module docstring): ``python -m repro_torch.bench --quick
    --out`` through its ``main()`` on the card in a fresh process, its
    launch counts read at its end; the document, its env and names; the
    gate against the committed ``BENCH_torch_*.json``; the paper-table
    drivers' CSV rows. Returns the suites' launch counts."""
    import contextlib
    import io
    import shutil

    import torch

    from repro_torch.bench import JSON_SUITES, schema
    from repro_torch.bench.__main__ import main as bench_main

    t_phase = time.perf_counter()
    out_dir = SMOKE_DIR / "bench"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    out = str(out_dir / "bench_quick.json")
    # the suites run in a process of their own, as the committed baselines
    # were made: after the phases before it, this process pays more host
    # time for each small launch than a fresh one (up to about twice), and
    # the sub-millisecond entries are mostly that
    proc = subprocess.run(
        [sys.executable, "-c", BENCH_SUITES_SCRIPT, out], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [
            str(ROOT / "src"), os.environ.get("PYTHONPATH")]))},
        capture_output=True, text=True, timeout=600)
    sys.stderr.write(proc.stderr[-4000:])
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    rc = proc.returncode
    check(rc == 0 and last[0].startswith("{"),
          f"python -m repro_torch.bench --quick exited {rc}: "
          f"{proc.stdout[-2000:]}")
    counts = json.loads(last[0])
    t_suites = time.perf_counter() - t_phase
    doc = schema.load_doc(out)
    env = doc["env"]
    name, limit = (x.strip() for x in card.rsplit(",", 1))
    print(f"[bench] repro_torch.bench --quick on {kind}: {t_suites:.1f} s, "
          f"env={env}, launches={counts}", flush=True)
    check(doc["quick"] and env["backend"] == "cuda",
          f"the bench document is not a --quick CUDA run: {env}")
    check(env["device_name"] == name and env["power_limit"] == limit,
          f"the bench env names {env['device_name']!r} at "
          f"{env['power_limit']!r}, nvidia-smi says {card!r}")
    for kname in BENCH_KERNELS:
        check(counts[kname] >= 1, f"the bench suites never launched {kname}")
    want = bench_names()
    for suite, entries in doc["suites"].items():
        got = [e["name"] for e in entries]
        check(got == want[suite], f"bench suite {suite}: entry names {got}, "
              f"expected the reference's {want[suite]}")
        for e in entries:
            print(f"[bench]   {e['name']} {e['us_per_call']} us "
                  f"{e['derived']}", flush=True)
    check(list(doc["suites"]) == list(JSON_SUITES),
          f"the bench document holds suites {list(doc['suites'])}")
    # the CLI prints the count compared and any regression; it exits 1 on
    # a regression and when nothing was compared
    baselines = [str(ROOT / f) for _, f in JSON_SUITES.values()]
    gate_rc = bench_main(["--gate", out] + [
        a for p in baselines for a in ("--baseline", p)])
    check(gate_rc == 0, f"the gate against the committed BENCH_torch_*.json "
          f"exited {gate_rc}")
    bench_path_checks(torch.device("cuda"))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        csv_rc = bench_main(["--csv", "--only", "table1,table2,fig1,fig3",
                             "--quick"])
    rows = buf.getvalue().splitlines()
    for row in rows:
        print(f"[bench] csv {row}", flush=True)
    check(csv_rc == 0 and not any("/ERROR," in r for r in rows),
          f"the paper-table drivers failed (rc {csv_rc})")
    check(len(rows) == 1 + 4 + 6 + 6 + 2,
          f"the paper-table drivers printed {len(rows) - 1} rows, expected "
          "table1 4, table2 6, fig1 6, fig3 2")
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"[bench] phase 15 took {time.perf_counter() - t_phase:.1f} s "
          f"(suites {t_suites:.1f} s, paper tables "
          f"{time.perf_counter() - t0:.1f} s) on {card}", flush=True)
    return counts


# ----------------------------------------------------------------- phase 19
SEL_FRAC = 0.01                  # THGSConfig's default sample_frac
SEL_VGG = ("cifar_vgg16.512x512x3x3", 2359296, 60199)
SEL_THGS_FL = dict(s0=0.01, alpha=0.9, s_min=0.001)    # the dry run's


def sel_embed_k() -> int:
    """Yi-6B ``embed``'s k under the dry run's THGS, as one flat leaf (its
    rank in the reference's leaf order picks its Eq. 1 rate)."""
    from repro_torch import configs, convert
    from repro_torch.core import schedules
    from repro_torch.core.types import THGSConfig
    from repro_torch.models import transformer as tf

    leaves = convert.reference_leaves(
        tf.init_params(configs.get("yi_6b"), device="meta"))
    sizes = [math.prod(lf.shape) for lf in leaves]
    i = [lf.path for lf in leaves].index("embed")
    return int(schedules.leaf_ks(THGSConfig(**SEL_THGS_FL), sizes)[i])


def sel_row_check(tag: str, n: int, k: int, seed: int, device) -> dict:
    """(a) at one full-width row: 'sampled' indices card vs CPU on a
    seeded accumulator, exact and sampled selection timed with CUDA events,
    ``sparsify_leaf`` card vs CPU, ``densify`` with duplicates through the
    scatter kernel against its plain fold."""
    import torch

    from repro_torch.core import sparsify as sp
    from repro_torch.core import streams as se
    from repro_torch.core.types import SparseStream, THGSConfig
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=device).manual_seed(seed)
    acc = torch.randn((1, n), generator=g, device=device)
    res = 0.2 * torch.randn((n,), generator=g, device=device)
    acc_c, res_c = acc.cpu(), res.cpu()
    got = se.select_topk_rows(acc, k, "sampled", SEL_FRAC)
    want = se.select_topk_rows(acc_c, k, "sampled", SEL_FRAC)
    same_sel = torch.equal(got.cpu(), want)
    overlap = int(torch.isin(got, se.select_topk_rows(acc, k)).sum())
    reps, inner = (3, 2) if n > 10**8 else (5, 10)
    ms = {"exact": [], "sampled": []}
    for sel in ("exact", "sampled", "sampled", "exact"):   # in turns
        ms[sel].append(events_ms(
            lambda s=sel: se.select_topk_rows(acc, k, s, SEL_FRAC),
            reps=reps, inner=inner, warmup=1))
    cfg = THGSConfig(selector="sampled", sample_frac=SEL_FRAC)
    out = sp.sparsify_leaf(acc[0], res, k, cfg)
    out_c = sp.sparsify_leaf(acc_c[0], res_c, k, cfg)
    same_sp = (bits_equal(out.stream.indices.cpu(), out_c.stream.indices)
               and bits_equal(out.stream.values.cpu(), out_c.stream.values)
               and bits_equal(out.residual.cpu(), out_c.residual)
               and bits_equal(out.threshold.cpu(), out_c.threshold))
    # the stream twice over, plus a heavy duplicate: slots fold in order
    idx = torch.cat([out.stream.indices, out.stream.indices.flip(0),
                     out.stream.indices[:1].expand(4096)])
    val = torch.cat([out.stream.values, -0.5 * out.stream.values,
                     torch.linspace(-1, 1, 4096, device=device)])
    before = ops.launch_counts()["stream_scatter_add"]
    dense = sp.densify(SparseStream(idx, val), n)
    launched = ops.launch_counts()["stream_scatter_add"] - before
    plain = ref.stream_scatter_add_ref(idx.cpu(), val.cpu(), n)
    same_dense = bits_equal(dense.cpu(), plain)
    print(f"[selectors] (a) {tag} n={n} k={k} f={SEL_FRAC}: sampled "
          f"indices card vs CPU bit-equal={same_sel}, {overlap} of {k} in "
          f"the exact top-k; selection ms (CUDA events, median of "
          f"{reps} x {inner} calls, in turns) exact {ms['exact'][0]:.4f} / "
          f"{ms['exact'][1]:.4f}, sampled {ms['sampled'][0]:.4f} / "
          f"{ms['sampled'][1]:.4f}; sparsify_leaf "
          f"card vs CPU bit-equal={same_sp} (threshold "
          f"{float(out_c.threshold):.6g}); densify of {idx.numel()} slots "
          f"with duplicates: {launched} scatter launch, bit-equal to the "
          f"plain fold={same_dense}", flush=True)
    check(same_sel, f"{tag}: sampled selection differs card vs CPU")
    check(same_sp, f"{tag}: sparsify_leaf differs card vs CPU")
    check(launched == 1, f"{tag}: densify launched the scatter {launched} "
          "times, expected 1")
    check(same_dense, f"{tag}: densify differs from the plain fold")
    return ms


def sel_table2_quick(kind: str) -> dict:
    """(b) table2_quick under 'exact', 'local' and 'sampled' on the card;
    returns the sampled run's launch counts."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    base = presets.get("table2_quick").replace(out_json=None)
    runs = {}
    for sel in ("exact", "local", "sampled"):
        cfg = base.replace(thgs=dataclasses.replace(base.thgs,
                                                    selector=sel))
        sim = Simulation(cfg, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = sim.run()
        torch.cuda.synchronize()
        runs[sel] = (sim, res, ops.launch_counts())
        t2 = res.ledger.totals("paper")
        print(f"[selectors] (b) table2_quick selector={sel} on {kind}: "
              f"launches stream_scatter_add="
              f"{runs[sel][2]['stream_scatter_add']} pair_mask_streams="
              f"{runs[sel][2]['pair_mask_streams']} upload_vs_dense(paper)="
              f"{t2['upload_vs_dense']:.6f} final_acc={res.final_acc:.4f} "
              f"accs={res.accuracies} wall_s={res.wall_s:.4f}", flush=True)
    (se_, re_, _), (sl, rl, _) = runs["exact"], runs["local"]
    same = (all(bits_equal(se_.state.params[n], sl.state.params[n])
                for n in se_.state.params)
            and all(bits_equal(se_.state.residuals[c][n],
                               sl.state.residuals[c][n])
                    for c in se_.state.residuals for n in se_.state.params)
            and re_.ledger.entries == rl.ledger.entries)
    print(f"[selectors] (b) local == exact (params, residuals, ledger): "
          f"{same}", flush=True)
    check(same, "table2_quick under 'local' differs from 'exact'")
    sim, res, counts = runs["sampled"]
    rounds = base.rounds
    check(counts["stream_scatter_add"] == 4 * rounds
          and counts["pair_mask_streams"] == rounds,
          f"sampled table2_quick launched {counts}, expected "
          f"stream_scatter_add {4 * rounds} and pair_mask_streams {rounds}")
    up = res.ledger.totals("paper")["upload_vs_dense"]
    check(abs(up - 0.091) <= 0.005 and res.final_acc >= 0.98,
          f"sampled table2_quick: upload_vs_dense {up:.6f} outside 9.1% "
          f"+- 0.5 or final_acc {res.final_acc:.4f} < 0.98")
    check(all(torch.isfinite(p).all() for p in sim.state.params.values()),
          "non-finite parameters after sampled table2_quick")
    return counts


def sel_vgg16(kind: str) -> dict:
    """(c) VGG16 under the table2 protocol, 2 rounds, 'sampled' against
    'exact' in turns (exact, sampled, sampled, exact: the first run pays
    the warm-up): round and encode ms; round 0's encode of a 512x512x3x3
    leaf in the first sampled run replayed on the CPU from the same
    accumulators, bit-equal. Returns the first sampled run's launch
    counts."""
    import dataclasses

    import torch

    from repro_torch.core import streams as se
    from repro_torch.kernels import ops
    from repro_torch.sim.engine import Simulation

    encode = se.encode_leaf_batch
    spent = []

    def timed_encode(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = encode(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    counts, probe = {}, {}
    for sel in ("exact", "sampled", "sampled", "exact"):
        cfg = vgg16_table2()
        cfg = cfg.replace(thgs=dataclasses.replace(cfg.thgs, selector=sel))
        sim = Simulation(cfg, device="cuda")

        def hook(leaf_id, name, info):
            if info["size"] == SEL_VGG[1] and not probe:
                probe.update(clone_info(info), leaf_id=leaf_id)

        if sel == "sampled" and not probe:
            sim.leaf_hook = hook
        spent.clear()
        se.encode_leaf_batch = timed_encode
        try:
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            res = sim.run()
            torch.cuda.synchronize()
            counts.setdefault(sel, ops.launch_counts())
        finally:
            se.encode_leaf_batch = encode
        print(f"[selectors] (c) VGG16 table2 selector={sel} on {kind}: "
              f"rounds={cfg.rounds} round_s={res.wall_s / cfg.rounds:.4f} "
              f"encode_ms={1e3 * sum(spent):.3f} ({len(spent)} leaf "
              f"encodes, the device synchronized around each) "
              f"launches={ops.launch_counts()} accs={res.accuracies} "
              f"upload_vs_dense(paper)="
              f"{res.ledger.totals('paper')['upload_vs_dense']:.6f}",
              flush=True)
        check(all(torch.isfinite(p).all() for p in sim.state.params.values()),
              f"non-finite VGG16 parameters under {sel}")
        del sim
        gc.collect()
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v)
           for k, v in probe.items()}
    size = cpu["size"]
    st, nr = se.encode_leaf_batch(
        cpu["updates"], cpu["residuals"], k=cpu["k"], nb=1, m=size,
        size=size, selector="sampled", sample_frac=SEL_FRAC,
        pair_seeds=cpu["pair_seeds"], pair_signs=cpu["pair_signs"],
        k_mask=cpu["k_mask"], mask_p=-1.0, mask_q=2.0,
        leaf_id=cpu["leaf_id"], weights=cpu["weights"])
    same = (bits_equal(st.indices, cpu["streams"].indices.cpu())
            and bits_equal(st.values, cpu["streams"].values.cpu())
            and bits_equal(nr, cpu["new_residuals"]))
    print(f"[selectors] (c) round 0's sampled encode of the 512x512x3x3 "
          f"leaf (k={cpu['k']} k_mask={cpu['k_mask']}) replayed on the "
          f"CPU: streams and residuals bit-equal={same}", flush=True)
    check(same, "VGG16's sampled encode differs card vs CPU")
    return counts["sampled"]


def selectors_phase(kind: str, card: str, device) -> dict:
    """Phase 19: the 'sampled' and 'local' selectors on the card; returns
    the launch counts of the sampled runs of (b) and (c)."""
    t_phase = time.perf_counter()
    sel_row_check(SEL_VGG[0], SEL_VGG[1], SEL_VGG[2], 19, device)
    sel_row_check("yi_6b.embed", 64000 * 4096, sel_embed_k(), 20, device)
    t2_counts = sel_table2_quick(kind)
    vgg_counts = sel_vgg16(kind)
    counts = {n: t2_counts[n] + vgg_counts[n] for n in t2_counts}
    print(f"[selectors] phase 19 took {time.perf_counter() - t_phase:.1f} s "
          f"on {card}; sampled-path launches {counts}", flush=True)
    return counts


# ----------------------------------------------------------------- phase 20
DEMO_ERR_TOL = 1e-5      # facts 3 and 4 (the reference prints 2.38e-07)
DEMO_INT_FACTS = ("n", "k", "k_mask", "dh_secret", "dh_secret_other", "t",
                  "n_phase1_shares", "slots", "masked_slots", "clear_slots",
                  "n_recovery_shares", "sparse_bytes", "share_bytes",
                  "dense_bytes")


def secagg_demo_phase(kind: str, device) -> tuple[dict, dict]:
    """The secure-aggregation walkthrough (``repro_torch.secagg.demo``) on
    the card, counts reset just before and read just after, then on the
    CPU: both kernels launched, streams and the three decoded sums
    bit-equal, facts 3 and 4 below ``DEMO_ERR_TOL``, the integer facts
    equal; then the scatter at the round decode's stream and the flat
    pair-mask call at the encode's 6 pairs against their plain versions,
    timed. Returns (the counts, the kernel rows)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.secagg import demo

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    card = demo.run("cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    plain = demo.run("cpu")
    print("[secagg_demo] " + demo.report(card).replace("\n", "\n[secagg_demo] "),
          flush=True)
    same = {name: bits_equal(card[name], plain[name])
            for name in ("indices", "values", "dense", "dense_drop",
                         "dense_no_recovery")}
    ints = {name: (card[name], plain[name]) for name in DEMO_INT_FACTS}
    print(f"[secagg_demo] on {kind}: launches={counts} card == CPU "
          f"bit-equal {same}; exact err {card['exact_err']:.3e} (CPU "
          f"{plain['exact_err']:.3e}), no recovery {card['no_recovery_err']:.4f}"
          f", recovered {card['recovered_err']:.3e} (CPU "
          f"{plain['recovered_err']:.3e}); integer facts equal "
          f"{all(a == b for a, b in ints.values())}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("stream_scatter_add", "pair_mask_streams"):
        check(counts[name] > 0, f"the walkthrough never launched {name}")
    check(all(same.values()), f"card != CPU in the walkthrough: {same}")
    check(card["exact_err"] < DEMO_ERR_TOL and
          card["recovered_err"] < DEMO_ERR_TOL,
          f"walkthrough errors {card['exact_err']:.3e} / "
          f"{card['recovered_err']:.3e} not below {DEMO_ERR_TOL}")
    check(all(a == b for a, b in ints.values()),
          f"walkthrough facts differ card vs CPU: "
          f"{ {k: v for k, v in ints.items() if v[0] != v[1]} }")
    # the kernels at the walkthrough's shapes against their plain versions
    n = card["n"]
    it = card["indices"].reshape(-1).to(device)
    vt = card["values"].reshape(-1).to(device)
    _, err = scatter_check("secagg_demo round decode", it, vt, n)
    scatter = dict(scatter_row("secagg_demo round decode", it, vt, n,
                               device), max_abs_err=err)
    masks = flat_mask_rows([("secagg_demo", n, card["k"], card["k_mask"],
                             len(demo.BANKS))], device)
    return counts, {"stream_scatter_add": [scatter],
                    "pair_mask_streams": masks}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                 "port on one NVIDIA GPU (see the module "
                                 "docstring).")
    ap.add_argument("--only",
                    choices=["flash", "pack", "masks", "sharded", "bench",
                             "families", "train", "fl_train", "selectors",
                             "secagg_demo", "tp"],
                    help="run the device and build phases and then [flash] "
                    "(the MMA counts printed, not required), the bit-pack "
                    "kernels' checks and times and one codec_wire_roundtrip "
                    "probe, the pair-mask kernel's flat and round rows "
                    "and one round's mask path probe, [sharded], [bench], "
                    "[families], [train], [fl_train], [selectors], "
                    "[secagg_demo], the tensor-parallel cases (the serving "
                    "grid's, [train] (f) to (j) and [fl_train] (f), (g), "
                    "(h)) alone, with no "
                    "result line: a "
                    "kernel's "
                    "times on a "
                    "tree, for a comparison of two trees in one call")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs one "
             "CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi unavailable"
    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} kind={kind} "
          f"count={torch.cuda.device_count()}", flush=True)
    from repro_torch.kernels import build, ops

    build.build_all(verbose=True)
    print(f"[build] {len(build.SOURCES)} CUDA sources built in "
          f"{build.build_seconds:.1f} s into {build.build_dir()}", flush=True)
    from repro_torch.core import schedules
    from repro_torch.core.types import SecureAggConfig, THGSConfig
    from repro_torch.models.paper_models import build_model

    thgs = THGSConfig(s0=0.05, alpha=0.9, s_min=0.01)
    sa = SecureAggConfig(mask_ratio=0.01)
    shapes = []
    for model, leaf, rounds in (("mnist_mlp", "l0.w", 12),
                                ("cifar_vgg16", "c10.w", 28)):
        names = build_model(model).leaf_names()
        sizes = [build_model(model).params()[n].numel() for n in names]
        i = names.index(leaf)
        k = schedules.leaf_ks(thgs, sizes, t=0, total_rounds=rounds)[i]
        shapes.append((f"{model}.{leaf}", sizes[i], k,
                       sa.k_mask_for(sizes[i], 5), 5))
    # VGG16's 512x512x3x3 leaf at the largest round-0 k of its quantized
    # levels that an earlier leaf position would draw (a denser stream)
    shapes.append(("cifar_vgg16.512x512x3x3@k60199", 2359296, 60199,
                   sa.k_mask_for(2359296, 5), 5))
    if args.only == "flash":      # any tree, a parent's kernel too
        flash_phase(device, require_mma=False)
        print(f"[done] --only flash passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "pack":     # any tree, the parent's unsegmented packs too
        pack_kernel_phase(device)
        wire_roundtrip_probe(device)
        print(f"[done] --only pack passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "bench":
        bench_phase(kind, card)
        print(f"[done] --only bench passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "families":
        families_phase(card)
        print(f"[done] --only families passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "train":
        train_phase(card)
        print(f"[done] --only train passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "fl_train":
        fl_train_phase(card, device)
        print(f"[done] --only fl_train passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "tp":
        serve_tp_layers(card)
        serve_family_layers(card)
        serve_long_layers(card)
        serve_long_yi6b(card)
        serve_grid_yi6b(card)
        serve_grid_moe(card)
        train_tp_phase(card)
        fl_tp(card)
        fl_tp_moe(card)
        fl_tp_ssm(card)
        print(f"[done] --only tp passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "selectors":
        selectors_phase(kind, card, device)
        print(f"[done] --only selectors passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "secagg_demo":
        secagg_demo_phase(kind, device)
        print(f"[done] --only secagg_demo passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "sharded":
        sharded_phase(kind, card, device)
        print(f"[done] --only sharded passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.only == "masks":    # any tree, the parent's per-leaf launches too
        mask_round_rows(device)
        flat_mask_rows(shapes[::2], device)
        mask_path_probe(device)
        print(f"[done] --only masks passed in "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)
        return 0

    # -------------------------------------------------------- 2. kernels
    rows = kernel_phase(shapes, device)
    # the round launch first: it is what the main path launches
    rows["pair_mask_streams"] = (mask_round_rows(device)
                                 + flat_mask_rows(shapes[::2], device))
    mask_path_probe(device)
    rows["stream_scatter_add"].append(scatter_tree_group_row(device))
    scatter_cases(device)
    rows.update(pack_kernel_phase(device))
    split_rows, split_counts = split_mask_kernel_phase(device)
    rows.update(split_rows)

    # ------------------------------------------------------ 3. main path
    from repro_torch.sim import presets
    from repro_torch.sim.engine import Simulation

    cfg = presets.get("table2_quick").replace(out_json=None)
    # one warm-up round first (cuBLAS handles, allocator, first launches), so
    # the main run's wall time is the steady state
    Simulation(cfg.replace(rounds=1), device="cuda").run()
    sim = Simulation(cfg, device="cuda")
    probe = {}

    def first_leaf(leaf_id, name, info):
        if name == "l0.w" and not probe:
            probe.update(clone_info(info), leaf_id=leaf_id)

    sim.leaf_hook = first_leaf
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = sim.run()
    main_counts = ops.launch_counts()
    t2 = res.ledger.totals("paper")
    print(f"[main] table2_quick on {kind}: rounds={cfg.rounds} "
          f"launches={main_counts} upload_vs_dense(paper)="
          f"{t2['upload_vs_dense']:.6f} (tpu "
          f"{res.ledger.totals('tpu')['upload_vs_dense']:.6f}) "
          f"final_acc={res.final_acc:.4f} accs={res.accuracies} "
          f"wall_s={res.wall_s:.4f} round_s={res.wall_s / cfg.rounds:.4f}",
          flush=True)
    for name in ("stream_scatter_add", "pair_mask_streams"):
        check(main_counts[name] > 0, f"main path never launched {name}")
    check(main_counts["pair_mask_streams"] == cfg.rounds,
          f"table2_quick launched pair_mask_streams "
          f"{main_counts['pair_mask_streams']} times, expected one a round "
          f"({cfg.rounds})")
    check(abs(t2["upload_vs_dense"] - 0.091) <= 0.005,
          f"upload_vs_dense {t2['upload_vs_dense']:.4f} outside 9.1% +- 0.5")
    check(res.final_acc >= 0.98, f"final_acc {res.final_acc:.4f} < 0.98")
    check(all(torch.isfinite(p).all() for p in sim.state.params.values()),
          "non-finite parameters after table2_quick")
    # round 0's l0.w encode + decode, replayed on the CPU from the same
    # inputs with the plain versions: streams, residuals and the decoded sum
    # are bit-equal to what the card computed
    from repro_torch.core import streams as se

    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in probe.items()}
    size = cpu["size"]
    st, nr = se.encode_leaf_batch(
        cpu["updates"], cpu["residuals"], k=cpu["k"], nb=1, m=size,
        size=size, pair_seeds=cpu["pair_seeds"], pair_signs=cpu["pair_signs"],
        k_mask=cpu["k_mask"], mask_p=-1.0, mask_q=2.0, leaf_id=cpu["leaf_id"],
        weights=cpu["weights"])
    dense = se.decode_leaf_batch(st, nb=1, m=size, size=size,
                                 k_mask=cpu["k_mask"])
    same = (bits_equal(st.indices, probe["streams"].indices.cpu())
            and bits_equal(st.values, probe["streams"].values.cpu())
            and bits_equal(nr, cpu["new_residuals"])
            and bits_equal(dense, cpu["dense"]))
    print(f"[main] round 0 leaf l0.w (k={cpu['k']} k_mask={cpu['k_mask']} "
          f"slots={st.indices.numel()}) replayed on the CPU: streams, "
          f"residuals and decoded sum bit-equal={same}", flush=True)
    check(same, "the card's round-0 l0.w encode/decode differs from the "
          "CPU replay")

    # ------------------------------------------------------- 4. recovery
    cfg = presets.get("secagg_quick").replace(out_json=None)
    sim = Simulation(cfg, device="cuda")
    n_leaves = len(sim.model.leaf_names())
    per_round, captured = [], {}

    def leaf_hook(leaf_id, name, info):
        if info["dropped"] and name == "l0.w" and "info" not in captured:
            captured["info"] = clone_info(info)

    def round_hook(r, info):
        per_round.append((r, list(info["dropped"]), ops.launch_counts()))

    sim.leaf_hook = leaf_hook
    ops.reset_launch_counts()
    res = sim.run(hooks=[round_hook])
    prev = {k: 0 for k in ops.KERNELS}
    dropped_rounds = 0
    for r, dropped, counts in per_round:
        pm = counts["pair_mask_streams"] - prev["pair_mask_streams"]
        dropped_rounds += bool(dropped)
        want = 2 if dropped else 1
        check(pm == want,
              f"round {r}: launched pair_mask_streams {pm} times for "
              f"{n_leaves} leaves, expected {want} (the masks of every "
              f"leaf{', then every recovery stream' if dropped else ''})")
        prev = counts
    check(dropped_rounds > 0, "secagg_quick dropped no client")
    check("info" in captured, "no dropout round reached the leaf hook")
    info = captured["info"]
    want = plain_unmasked_sum(info)
    got = info["dense"].cpu()
    err = (got - want).abs().max().item()
    tol = 64 * 2.0 ** -24
    print(f"[recovery] secagg_quick: {dropped_rounds} dropout round(s), "
          f"dropped={info['dropped']} launches={ops.launch_counts()} "
          f"decoded vs plain unmasked sum max abs err {err:.3e} "
          f"(tolerance 64 * 2^-24 = {tol:.3e}) final_acc={res.final_acc:.4f}",
          flush=True)
    check(err <= tol, f"recovered aggregate off by {err:.3e}")

    # ------------------------------------------------- 5. full-size model
    cfg = vgg16_table2()
    sim = Simulation(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = sim.run()
    vgg_counts = ops.launch_counts()
    finite = all(torch.isfinite(p).all() for p in sim.state.params.values())
    print(f"[vgg16] cifar_vgg16 table2 protocol: rounds={cfg.rounds} "
          f"params={sim.model.n_params()} launches={vgg_counts} "
          f"wall_s={res.wall_s:.4f} accs={res.accuracies} "
          f"upload_vs_dense(paper)="
          f"{res.ledger.totals('paper')['upload_vs_dense']:.6f} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"finite={finite}", flush=True)
    check(finite, "non-finite VGG16 parameters")
    for name in ("stream_scatter_add", "pair_mask_streams"):
        check(vgg_counts[name] > 0, f"VGG16 rounds never launched {name}")
    check(vgg_counts["pair_mask_streams"] == cfg.rounds,
          f"VGG16 launched pair_mask_streams "
          f"{vgg_counts['pair_mask_streams']} times for "
          f"{len(sim.model.leaf_names())} leaves, expected one a round")

    # --------------------------------------------------------- 6. codecs
    codec_counts = codec_phase(kind)

    # ------------------------------------------------------------- 7. DP
    dp_phase(kind)

    # ---------------------------------------------------- 8-9. tree, async
    t_phase = time.perf_counter()
    tree_phase(kind)
    async_phase(kind)
    print(f"[async] phases 8-9 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # --------------------------------------------------------- 10. flash
    t_phase = time.perf_counter()
    rows["flash_attention"] = flash_phase(device)

    # ------------------------------------------------------------ 11. LM
    lm_counts = lm_phase(kind, card, rows["flash_attention"][0]["ms"])
    print(f"[lm] phases 10-11 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ------------------------------------------------------ 16. families
    family_counts = families_phase(card)

    # --------------------------------------------------------- 17. train
    train_phase(card)

    # ------------------------------------------------------ 18. fl_train
    fl_row, fl_counts = fl_train_phase(card, device)
    rows["stream_scatter_add"].append(fl_row)

    # ------------------------------------------------ 12-13. resume, serve
    t_phase = time.perf_counter()
    resume_phase(kind)
    serve_phase(kind)
    print(f"[serve] phases 12-13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ------------------------------------------------------- 14. sharded
    sharded_counts, row_rows = sharded_phase(kind, card, device)
    rows["pair_mask_streams"] += row_rows

    # --------------------------------------------------------- 15. bench
    bench_phase(kind, card)

    # ----------------------------------------------------- 19. selectors
    sel_counts = selectors_phase(kind, card, device)

    # --------------------------------------------------- 20. secagg_demo
    demo_counts, demo_rows = secagg_demo_phase(kind, device)
    for name, extra in demo_rows.items():
        rows[name] += extra

    # ------------------------------------------------------------ report
    sources = {"stream_scatter_add": ("src/repro_torch/kernels/csrc/"
                                      "stream_scatter_add.cu",
                                      "src/repro/kernels/stream_decode.py:57"),
               "pair_mask_streams": ("src/repro_torch/kernels/csrc/"
                                     "pair_mask_streams.cu",
                                     "src/repro/kernels/mask_prng.py:97"),
               "bitpack_rows": ("src/repro_torch/kernels/csrc/bitpack.cu",
                                "src/repro/kernels/pack.py:42"),
               "bitunpack_rows": ("src/repro_torch/kernels/csrc/bitpack.cu",
                                  "src/repro/kernels/pack.py:65"),
               "flash_attention": ("src/repro_torch/kernels/csrc/"
                                   "flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:77"),
               "thgs_sparsify": ("src/repro_torch/kernels/csrc/"
                                 "thgs_sparsify.cu",
                                 "src/repro/kernels/thgs_sparsify.py:29"),
               "mask_prng_apply": ("src/repro_torch/kernels/csrc/"
                                   "pair_mask_streams.cu",
                                   "src/repro/kernels/mask_prng.py:38")}
    # each kernel's launches come from the path that runs it: table2_quick
    # and the sharded parity runs for the scatter and the masks (the
    # scatter also the federated Yi-6B steps of [fl_train], (c)'s whole
    # model, (d)'s placed step and (e)'s sharded one; both also the
    # sampled runs of [selectors] and the walkthrough of [secagg_demo]),
    # codec_sweep_quick and its sharded int8 arm for the bit packing, the
    # served Yi-6B and the families' first prefills for the flash
    # attention; no reference path calls the THGS split or the dense mask
    # apply, whose path is the public ops API (the [kernels] phase's ops
    # path over every leaf of two models)
    launches = {**main_counts,
                "stream_scatter_add": (main_counts["stream_scatter_add"]
                                       + sharded_counts["stream_scatter_add"]
                                       + fl_counts["stream_scatter_add"]
                                       + sel_counts["stream_scatter_add"]
                                       + demo_counts["stream_scatter_add"]),
                "pair_mask_streams": (main_counts["pair_mask_streams"]
                                      + sharded_counts["pair_mask_streams"]
                                      + sel_counts["pair_mask_streams"]
                                      + demo_counts["pair_mask_streams"]),
                **{n: codec_counts[n] + sharded_counts[n]
                   for n in ("bitpack_rows", "bitunpack_rows")},
                "flash_attention": (lm_counts["flash_attention"]
                                    + family_counts["flash_attention"]),
                "thgs_sparsify": split_counts["thgs_sparsify"],
                "mask_prng_apply": split_counts["mask_prng_apply"]}
    notes = {name: "no reference path calls this kernel: launches are the "
             "[kernels] phase's ops path over every leaf of mnist_mlp and "
             "cifar_vgg16" for name in ("thgs_sparsify", "mask_prng_apply")}
    kernels = []
    for name in ops.KERNELS:
        main_row = rows[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            **({"note": notes[name]} if name in notes else {}),
            "shapes": rows[name]})
    print(f"[done] all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
