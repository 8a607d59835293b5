"""Chip smoke test of mpit_tpu_torch: the port's serving paths (one server,
and the disaggregated fleet with its KV shipments) and training paths on
one GPU, training on one rank and over four data-parallel ranks.

    python3 chip_smoke.py
    python3 chip_smoke.py dp_profile ring_q8   # phase 4d's profile of one mode alone
    python3 chip_smoke.py convnets             # phases 4c, 4cd, 4cp and 5c alone
    python3 chip_smoke.py resnet               # 3e at ResNet-50's plan, then 4r, 4rd, 5r
    python3 chip_smoke.py recovery             # phases 4k, 4kd, 4kx and 4e alone
    python3 chip_smoke.py elastic 10           # phase 4e alone, ten times over
    python3 chip_smoke.py spec                 # phases 3s, 4s, 5s and 4z (after 4 and 5)
    python3 chip_smoke.py tp                   # phases 3m, 4m and 5m (after 5)
    python3 chip_smoke.py policy               # phase 4p alone
    python3 chip_smoke.py tiers                # phases 3t, 4mt and 4sq alone

Run from the root of a checkout on a machine with an NVIDIA GPU (written
for an H100). Phases, each of which raises (exit code != 0) on failure:

1. device — CUDA must be available; prints the card's name and power
   limit (``nvidia-smi``);
2. build — compiles every kernel source of the port with ``nvcc`` (one
   process per source, all at once); compiler output goes to
   ``chiprun_out/chip_smoke_build.log``;
3. kernel vs plain, dense — the flash-decode kernel against its plain
   PyTorch version at GPT-2 small's head geometry (8 slots, 12 heads,
   head dim 64) for cache lengths 512 and 1024, query widths 1 (a decode
   tick) and 128 (a prefill), bf16 and f32, with slot lengths spread from
   0 to S - T: max |error| within 1e-4 (f32) / 5e-2 (bf16, the JAX
   package's own bf16 kernel tolerance), visited-tile counts exact;
   times the kernel, its plain version and ``scaled_dot_product_attention``
   (the library yardstick, never called by the port) with CUDA events on
   a cold L2, after a second of matmuls that lifts the clocks from idle,
   beside the bound the card's HBM rate and peak arithmetic
   rate set for the same work, and beside the earlier design's time at the same shape
   (``BEFORE_DECODE_MS``). Each case names the kernel body it ran
   (``path``: ``split`` at T = 1, ``mma`` for bf16 q and K/V at T > 1,
   ``q8mma`` for bf16 q over int8 K/V at T > 1, ``rows`` otherwise) and
   fails unless exactly that body's launch count moved;
3b. kernel vs plain, paged and int8 — the three other forms at the same
   head geometry: paged pools of page size 16 and 64 for virtual lengths
   512 and 1024, T = 1 and 64 (a prefill chunk), q bf16/f32 over K/V of
   the same dtype and over int8 K/V; dense int8 at S 512/1024, T 1/64/128
   (128: the dense serving runs' prefill width).
   Block tables name a seeded random permutation of the pool's pages,
   two slots sharing their first pages. Tolerances are q's: both sides
   dequantize the same int8 bytes to f32, and with a bf16 q the kernel
   keeps p in f32 (as on the TPU, V is f32 once dequantized; the q8mma
   body carries p times the V scale as three bf16 pieces that sum to it
   within 2^-27) where the plain version rounds the probabilities to
   bf16 — well inside 5e-2.
   The paged kernel over the pre-gathered dense view, mapped page by
   page in order, must equal the dense kernel bit for bit at the same
   block_k, on each body (split, mma, q8mma and rows alike). SDPA runs on the
   pre-gathered (and dequantized) dense view; the gather is not timed.
   Every case goes to
   ``chiprun_out/chip_smoke_kernels.json``;
3c. kernel vs plain, int8 weights — the fused-dequant matmul against its
   plain version (the blocked dequant-and-contract loop) at GPT-2
   small's four dense-layer shapes (D, F) = (768, 2304), (768, 768),
   (768, 3072), (3072, 768) for M = 8 (a decode tick of 8 slots), 512 (a
   paged prefill chunk of 8 x 64) and 1024 (a dense prefill of 8 x 128),
   x f32 and bf16, plus a ragged M 5, D 100, F 130, and in bf16 the
   plan's edges M 1, 9 and 64: max |error| within 1e-4 x max(1, max
   |plain|) for both x dtypes (both sides sum f32 products of the same
   dequantized weights: bf16 -> f32 is exact, and the ``mma`` body's three
   bf16 pieces of a weight sum to it exactly). Each case runs one launch
   on the body the C library's plan names (``mpit_qmm_plan``: ``mma`` for
   bf16 x, ``fma`` for f32; counted in ``path_launches``) and records the
   plan's tile, split and blocks and the earlier design's time
   (``BEFORE_QMM_MS``). Times the kernel, the plain version and
   ``torch.matmul`` on the weight dequantized ahead of time (the library
   yardstick, dequant untimed, never called by the port) beside the
   bound; then, as in 3e, the kernel's and the library's device times
   without the host's lead (``device_ms``, ``library_device_ms``) and the
   wrapper's host time (``host_ms``);
4. serve — ``python -m mpit_tpu_torch.serve``'s ``main`` in process:
   GPT-2 small at full width (12 layers, d_model 768, 12 heads, vocab
   50257, random weights from seed 0) in bf16, 8 slots, 16 greedy
   requests of 32 new tokens, six times: the dense cache; the paged
   pool (256 pages of 16 tokens, prefill chunk 64); the paged pool with
   ``--kv-dtype int8``; the dense cache with ``--kv-dtype int8``; the
   dense cache with ``--weights-dtype int8``; the paged pool with
   ``--weights-dtype int8 --kv-dtype int8``. Every request completes
   with its tokens, and the launch count of the attention form each run
   drives, set to 0 just before, reaches at least num_layers x (prefill
   calls + decode ticks), while the other forms stay at 0; by body
   (``path_launches``), exactly num_layers x prefill calls on ``mma``
   (bf16 K/V) or ``q8mma`` (int8 K/V) and num_layers x decode ticks on
   ``split``, nothing else; the matmul
   kernel's count reaches 4 x num_layers x (prefill calls + decode
   ticks) in the two int8-weight runs, every launch on the ``mma`` body,
   and stays 0 in the other four;
   every run's record goes to ``chiprun_out/chip_smoke_serve.json``;
4q. int8-weight serving profile — phase 4's dense ``--weights-dtype int8``
   engine, rebuilt in process, under ``torch.profiler``: one prefill call
   (every slot's 128-token prompt, the matmul at M 1024) and then 8
   decode ticks (M 8), after one untimed prefill and tick: device busy
   time by kernel family (the matmul kernel's named), per prefill call
   and per tick, and the device's idle share of each window. Reports,
   gates nothing; "not measured" where the profiler records no device
   activity;
5. parity — f32 on the card, TF32 off, same weights: PR 1's stream
   through the dense kernel engine and the reference engine; then a
   shared-prefix stream of 16 greedy requests (8 behind one 70-token
   system prompt, two prompts each submitted twice a few ticks apart)
   through the paged kernel engine with 48 pages, whose greedy tokens
   must equal the dense reference engine's, with prefix hits, COW copies
   and an admission that waited on pages all non-zero. A divergence
   fails with its first token and the logit margin there. The same
   stream with int8 K/V on both sides: int8 rounding turns last-bit
   differences between two schedules of the same f32 math (cuBLAS GEMMs
   are not row-invariant in the batch's row count; the kernel sums in
   another order than the plain version) into whole quantization steps,
   so greedy tokens part at near-ties — the plain version run at the
   paged schedule parts from itself at the dense one. Each request must
   equal the dense reference, or part from it first where its two tokens'
   teacher-forced plain int8 logits lie within ``INT8_TIE`` of each
   other; every such divergence is printed with its gap and margin.
   Then PR 1's stream with int8 weights on both sides: the dense kernel
   engine (matmul and attention kernels) against the dense reference
   engine (whole-weight dequant), identical greedy tokens in f32 (both
   hold the same int8 bytes; only the summation order differs), and
   with int8 K/V as well, held to the ``INT8_TIE`` rule.

Speculative decoding and EASGD under the SPMD step, each path's launch
counts set to 0 just before it and read just after (records in
``chiprun_out/chip_smoke_spec.json``):

3s. kernel vs plain at the verify's shapes — the decode kernel at T = 2
   to 5, S 512, dense and paged (pages of 16), bf16 over bf16 (``mma``)
   and over int8 K/V (``q8mma``), against its plain version (5e-2) and
   SDPA on the same view; the int8 matmul at 40 rows (8 slots x 5) on
   GPT-2 small's four shapes against its plain version (1e-4 x max(1,
   max |plain|)) and ``torch.matmul`` over the dequantized weight, the
   same bits on three repeated calls;
4s. speculative serving — phase 4's runs with ``--spec-k 4
   --draft-config truncate:2`` (dense, paged, paged int8 K/V, dense int8
   weights): 16 of 16 requests and 512 tokens, every attention launch on
   the form's tensor-core body (prefill and the T = 5 verify; the draft
   runs plain attention), with int8 weights every matmul launch on
   ``mma`` (the target's and the draft's, counted exactly); greedy
   tokens against the plain run of the same form, a parting failing
   where the plain path, teacher-forced on the plain run's tokens, ranks
   the plain token above the speculative one by more than ``INT8_TIE``;
   a sampled run (temperature 1, top-k 50); acceptance, tokens per tick,
   decode tok/s beside phase 4's and a profile of eight speculative
   ticks (device time by family, idle share);
5s. speculative parity — f32 at GPT-2 small's width (phase 5's weights
   and stream, k 4, the first two layers as the draft): the kernel and
   the reference speculative engines against the plain kernel engine,
   partings within ``F32_TIE`` of the plain model teacher-forced;
4z. EASGD under SPMD — ``mnist --easgd true`` on one rank and over
   ``--mesh data=4`` through ``ring`` and ``ring_q8`` with ``--zero1``
   true and false (30 steps), ``imagenet`` (AlexNet at full width) over
   four ranks through ``ring`` for 8 steps: losses finite (LeNet's
   falling), the centre finite (the runs' states captured around
   ``make_train_step``), replicas bit-identical, ring launches buckets x
   steps, and the zero1 forms equal (``ring`` bit for bit: losses,
   parameters, centre; ``ring_q8`` within 0.02 + 0.02·|loss| over the
   first 20 steps, both ending below 0.5).

Tensor-parallel serving, ``--mesh model=p``: p ranks of GPT-2 small on
the one card, Megatron blocks and a head-sharded cache (records in
``chiprun_out/chip_smoke_tp.json``):

3m. kernel vs plain on a rank's shard — the decode kernel at 6 heads
   (p 2) and 3 heads (p 4), Dh 64, 8 slots, S 512, in each form (dense,
   paged 16, bf16 or int8 K/V) at T 1, 2 to 5 and the prefill width, and
   the int8 matmul on each layer's shard (p 2: 768 x 1152, 768 x 1536,
   384 x 768, 1536 x 768; p 4: 768 x 576, 768 x 768, 192 x 768, 768 x
   768) at M 8, 40 and 512, each against its plain version with phase
   3's and 3c's tolerances, beside SDPA over the shard or
   ``torch.matmul`` over the dequantized shard and the bound;
4m. TP serving — phase 4's configuration through the serve CLI's
   ``main`` with ``--mesh model=2`` and ``model=4``: dense, paged, paged
   int8 K/V, dense int8 weights, and at p 2 one speculative run (``--spec-k
   4 --draft-config truncate:2``, the draft replicated): 16 of 16
   requests and 512 tokens; attention launches p x layers a call by body;
   with int8 weights 4 x p x layers matmul launches a call, all ``mma``;
   greedy tokens against the one-rank run of the same form, a parting
   failing where the plain path, teacher-forced on the one-rank tokens,
   ranks the one-rank token above the TP run's by more than ``BF16_TIE``;
   tick p50 beside the one-rank tick, launches a tick, and profiles of
   eight dense ticks at p 1, 2 and 4 (device time by family, idle share);
5m. TP parity — f32 at GPT-2 small's width (phase 5's weights and
   stream): the TP kernel engine at p 2 and 4 and the TP reference engine
   at p 2, each 16 of 16 requests identical to phase 5's one-rank kernel
   engine.

Open-loop serving under the scheduling policy (records in
``chiprun_out/chip_smoke_policy.json``):

4p. ``python -m mpit_tpu_torch.serve``'s ``main`` once with ``--loadgen``,
   ``--policy`` and ``--kv-host-pages`` on the paged pool (every arrival
   answered, the paged form's ``split`` and ``mma`` bodies); then GPT-2
   small through the engine the CLI builds, 4 slots over 96 pages of 16,
   ``Server.run_timed`` over a seeded open-loop trace (8 req/s for 4 s,
   drained) of two classes, interactive (priority 0, a 20 ms TTFT target)
   and batch (priority 1, 96-160 new tokens), under the policy with
   admission shedding off: bf16 and int8 K/V with 160 host pages (resumes
   restream), int8 weights without (resumes recompute), and that
   int8-weight run again over GPT-2 small in f32. Gates: every
   arrival answered in full; preemptions above 0, and resumes of the
   run's mode (restreamed pages with the host tier); every restored page
   equal bit for bit to its page as the spill began (``PageCheck``);
   attention launches on the form's ``split`` and ``mma``/``q8mma``
   bodies alone (``rows`` for ``mma`` in f32), the matmul's all on
   ``mma`` (``fma`` in f32) in the int8-weight runs and none elsewhere;
   the preempted requests' tokens equal to their closed-loop run (FIFO,
   no policy, the same engine) or parted one-sided within ``BF16_TIE``
   in bf16 and ``F32_TIE`` in f32, the plain path teacher-forced (the
   open loop's schedule depends on the wall clock, so which requests
   are preempted, and where, differs from run to run). Prints spill and
   restore ms a page (32 pages, wall clock, idle engine), resume p50/p95
   by mode and TTFT p50/p95 by tier.

3d. kernel vs plain, flash attention — the forward, dq and dk/dv kernels
   against their plain versions at GPT-2 small's head geometry (B 8, H
   12, D 64) for T 512 and 1024, bf16 and f32, the backward fed by the
   plain chain's own delta; plus, at T 512 bf16, an offset case (q_offset
   256: every query tile sees the key tiles up to its own and the
   diagonal), a key block wholly in the future (k_offset 512: o exactly
   0 and lse exactly -1e30), a non-zero lse cotangent folded into delta,
   and q, k, v handed over as the model hands them, strided views of one
   fused qkv tensor (rows 3 H D apart), read in place. The f32 lse within
   an absolute 1e-4 in both dtypes (``LSE_TOL``: l summed from bf16-rounded
   p would move it by about 1e-3). Max |error| of o,
   dq, dk and dv within an absolute 1e-4 (f32) / 5e-2 (bf16, the
   JAX package's own bf16 kernel tolerance: bf16 outputs are rounded
   once, after sums taken in another order, and one bf16 step is 1.6e-2
   to 3.1e-2 at their largest values, 2 to 8); each case records the
   plain tensors' max |value| beside its errors. In f32 at T 512 the kernels' dq, dk,
   dv are also held against torch autograd through the plain forward
   (1e-4 likewise). Times each
   kernel, its plain version and the library yardstick on a cold L2
   beside the bound: ``scaled_dot_product_attention(is_causal=True)``
   for the forward, its autograd backward (dq, dk and dv in one call,
   the forward already run) for dq and dk/dv; neither gives an lse, and
   the port never calls them; beside the earlier design's time at the same case
   (``BEFORE_FLASH_MS``) and the body (``path``: ``mma`` for every bf16
   kernel on the tensor cores, ``fma`` for the f32 kernels, as the C
   library named it for each launch, counted in ``path_launches``; one
   launch of each kernel on that body, or the phase fails). Every case goes to
   ``chiprun_out/chip_smoke_flash.json``;
4t. train — ``python -m mpit_tpu_torch.asyncsgd gpt2``'s ``main`` in
   process with ``--flash true --steps 30 --log-every 1``: GPT-2 small at
   full width (12 layers, d_model 768, 12 heads, vocab 50257), seq 512,
   batch 8, bf16 activations, goo_adam at 3e-4, the fused LM-head loss
   with bf16 products. All 30 per-step losses are finite and the mean of
   steps 26-30 is below the mean of steps 1-5; the
   fwd, dq and dkv launch counts, set to 0 just before, each reach 12 x
   steps, and every dq launch ran the ``mma`` body. Prints step time p50/p95 (device timeline), tokens/s and peak
   device memory; times the LM head (``lm_head_xent`` forward and
   backward at 4096 tokens) on its own, and profiles three more steps
   (``torch.profiler``: device busy time by kernel family, idle share);
5t. train parity — f32, TF32 off, the same seeded initial weights, three
   goo_adam steps through the flash-kernel step and the plain-attention
   step at full width and depth: per-step losses within 1e-4 relative.

Training on the model, fsdp and seq axes, the pjit tier and the
context-parallel tier (records in ``chiprun_out/chip_smoke_tiers.json``):

3t. kernel vs plain in the tiers' forms — the flash forward, dq and
   dk/dv on a TP rank's head shard (B 8, T 512, 6 and 3 heads; f32 at 6;
   6 heads at B 4, a data rank's rows at data 2 x model 2),
   the ring block at every (q_offset, k_offset) that 4 seq ranks over
   T/S 128 give (B 4, 12 heads; the wholly-future blocks too: o exactly 0,
   lse exactly -1e30), each ring step's launch (step s over ranks s..3:
   B (4 - s) x 4 at offsets (128 s, 0); f32 at s 1) and Ulysses' inner
   call (B 4, T 512, 6 heads), with 3d's tolerances, beside SDPA where
   one call computes the block (causal on the diagonal, unmasked on a
   wholly visible block; none for a wholly-future one) and the bound;
   then f32 parity (TF32 off): GPT-2 small at full width and 2 layers,
   three goo_adam steps, the pjit tier at ``model=2``, ``model=4`` and
   ``data=2,model=2`` with FSDP against the one-rank step of its unfused
   loss, the CP tier (ring-flash, Ulysses-flash, plain ring) against its
   one-rank step: per-step losses within 1e-4 relative;
4mt. TP training — ``asyncsgd.gpt2``'s ``main`` with ``--flash true
   --steps 16``: GPT-2 small at full width (vocab 50257 padded per rank,
   12 layers, d 768, 12 heads, seq 512, batch 8, bf16, goo_adam) on
   ``--mesh model=2``, ``model=4`` and ``data=2,model=2 --fsdp-axis
   data``: finite losses whose last four average below the first four;
   fwd, dq and dkv launches, set to 0 just before, each exactly layers x
   model ranks x data ranks x steps, all on ``mma`` and all at the rank's
   geometry (B/data rows, 12/model heads); step time, tokens/s, MFU and
   peak memory; the ``model=2`` run's main path profiled by its own loop
   (``--profile-dir``: steps 2..5, device time by family, idle share);
4sq. CP training — the same model on ``--mesh data=2,seq=4`` (ring-flash),
   ``data=4,seq=2 --ulysses true`` (Ulysses-flash) and ``data=2,seq=4
   --flash false`` (the plain ring), unpatched: falling losses; launches
   by geometry as the ring gives them — ring-flash: layers x 2 x steps at
   each ring step s (B (4 - s) x 4, T/S 128, offsets (128 s, 0)); Ulysses:
   layers x 4 x steps at B 4, T 512, 6 heads; the plain ring none; then
   each run again for two untimed steps with every merged attention row
   checked finite on the card; the ring-flash run's main path profiled by
   its own loop, as 4mt's.
3e. kernel vs plain, ring collectives — the reduce-scatter and all-gather
   kernels, sum and int8 wire, against their plain versions (the same
   ring order hop by hop), BIT FOR BIT (the bits of every element, signed
   zeros too); the sum reduce-scatter runs as the fold (``schedule``
   ``fold``), the sum all-gather as the copy (``copy``), the q8
   reduce-scatter as the q8 fold and the q8 all-gather as the q8 copy,
   each on the form the C library's plan names (``q8fold_resident`` /
   ``q8copy_resident``: the partials / the shard rows in shared memory,
   one pass over HBM; ``q8fold_stream``: one pass a hop;
   ``q8copy_stream``: two; the case fails unless that form's launch
   count moved): p 2, 4 and 8 at 8192 rows a chunk (GPT-2 small's 4 MiB
   f32 bucket), f32 and bf16 for every form; GPT-2 small's ragged tail
   bucket at p 4, read in place from a wider buffer as the bucket loop
   reads it; an all-zero chunk (scale 1.0) in both q8 forms; payloads
   the planner must pad
   (the public collectives). Every gathered replica identical. Times
   each kernel, its plain version and the library yardstick
   (``xs.view(p, p, c).sum(0)`` for a reduce-scatter, an expand-and-copy
   of the concatenated shards for an all-gather; the port's ``psum``
   mode, never called by the ring modes) over 20 cold-L2 calls, beside
   the bound and the bytes the schedule itself moves (the resident
   forms' are the bound's); then, apart from those times, the kernel's and the
   library's device time with the host time before the launch left out
   (``device_ms``, ``library_device_ms``) and the wrapper's host time a
   call (``host_ms``). Every case goes to ``chiprun_out/chip_smoke_ring.json``;
4d. data-parallel train — phase 4t's run with ``--mesh data=4 --zero1
   true`` and ``--grad-sync ring``, then ``ring_q8``: four ranks on the
   card, 2 sequences each, ZeRO-1 through the ring kernels, 30 steps.
   30 finite losses, falling; the reduce-scatter and all-gather launch
   counts (set to 0 just before) each equal buckets x 30 for the run's
   form and 0 for the other (``ring``: the one-pass fold and copy, the
   only kernels of those kinds; ``ring_q8``: the q8 fold and the q8
   copy, every launch of each on the form the plan names for its bucket,
   counted in ``path_launches``); the flash counts 12 x 4 x 30 each; the four
   parameter replicas bit-identical after the run. Prints step p50/p95,
   tokens/s and peak memory; then profiles three ``ring`` steps and three
   ``ring_q8`` steps (device time by kernel family, the ring family by
   kernel, idle share);
5d. data-parallel parity — f32, three steps over four ranks from one set
   of weights: ``ring`` losses within 1e-5 relative of ``psum``'s (the
   ring sums the ranks in another order, so not bit-equal); bf16, the
   30-step 4d configuration under ``psum``: 4d's ``ring_q8`` curve within
   ``0.02 + 0.02·|loss|`` of it at every step (the JAX package's pin)
   and not identical to it.
3f. kernel vs plain, KV shipment — the copy kernel that carries every
   fleet shipment on the card against its plain version (``copy_`` on
   byte views), BIT FOR BIT: a 128-row shipment's leaves at GPT-2 small's
   width (k/v bf16 [12, 128, 12, 64], k.q/v.q int8, k.scale/v.scale f32
   [12, 128, 12, 1]), both packed payloads (bf16 4,718,592 bytes, int8
   2,506,752), ragged byte counts 1, 15, 17 and 4711, the bf16 payload
   with src and dst views at byte offsets misaligned against each other
   (1/3, 3/1, 1/0) and at one odd offset shared by both (3/3), and a 256
   MiB buffer. Each case names the body the C library's plan picked
   (``wave`` below 32 MiB, ``stream`` from there, counted in
   ``path_launches``) and holds both bodies bit-exact. Times the kernel, its plain
   version and ``dst.copy_(src)`` (the library yardstick, a device to
   device ``cudaMemcpyAsync``, never called by the port on this path) on
   a cold L2 beside the bound (read and write every byte once); then, as
   in 3e, the kernel's and the library's device times without the host's
   lead (``device_ms``, ``library_device_ms``) and the wrapper's host time
   (``host_ms``); at both payloads, 32 MiB and 256 MiB each body also on
   its own (``bodies``). Every case goes to ``chiprun_out/chip_smoke_ship.json``;
4f. fleet — ``python -m mpit_tpu_torch.serve --fleet``'s ``main`` in
   process at phase 4's configuration (GPT-2 small at full width, bf16,
   8 slots, 16 greedy requests of 32 new tokens), the JAX package's test
   liveness (heartbeat 0.05 s, lease 5 s): the dense cache with one
   prefill and one decode worker, the paged pool with int8 K/V and
   two decode workers, and the dense cache with ``--weights-dtype int8``
   and two decode workers (every worker's engine launches the matmul
   kernel from its own thread). Every request completes; the copy kernel's
   launches (set to 0 just before) reach 2 a shipment (the send snapshot
   and the delivery); the attention form's launches reach num_layers x
   (shipments + decode ticks) and no other form runs; the matmul kernel
   runs in the int8-weight fleet alone, at least 4 x num_layers x
   (shipments + decode ticks) times, all on ``mma``; each request's tokens equal the single Server's at the same
   configuration (phase 4's run, rebuilt in process) or part first at a
   near-tie (``INT8_TIE``, judged by the plain path teacher-forced on the
   Server's tokens, the int8-weight model for the int8-weight fleet: bf16
   cuBLAS GEMMs are not row-invariant in the prefill's row count, and the
   matmul's split contraction sums in another order at another row
   count, should a schedule change it). Prints wall time,
   requests/s, bytes shipped and the kernel's time a shipment; each
   run's record goes to ``chiprun_out/chip_smoke_fleet.json``;
5f. fleet parity — f32, ``run_fleet`` at full width with one prefill and
   two decode workers, 4 greedy requests: tokens identical to the single
   Server's; then the same with decode rank 2 killed entering its tick 5
   (``FaultPlan``, lease 0.75 s): at least one re-queue, tokens identical;
   the results go to ``chiprun_out/chip_smoke_fleet.json``.

The convnet workloads (BASELINE.json's configs #1-#3). Phase 3e also
holds the ring kernels at the convnets' bucket plans over four ranks
(AlexNet: 15 buckets of its 119,338-row shard, the first full 8192-row
bucket and the 4650-row tail, read in place from a wider buffer; LeNet:
one 122-row bucket), both kinds, sum and q8, bit for bit; phase 3f the
copy kernel at AlexNet's flat f32 message (61,101,056 elements,
244.4 MB), bit for bit, each body timed apart. Then, each through the
workload's ``main`` in process and raising on failure:

4c. convnets on one rank — ``imagenet`` at full width (224 x 224, 1000
   classes, bf16 compute, f32 parameters, goo SGD lr 0.01 momentum 0.9,
   batch 128, 30 steps, seed 0): finite losses, the last five's mean
   below the first five's; images/s at the step p50 (the host's data
   stream sets it), step p50/p95, peak memory; the same step over two
   batches staged on the card, alternated, timed with CUDA events after
   five warm-up steps, and profiled for three steps (device time by
   kernel family: convolutions, GEMMs, pooling, elementwise, optimizer,
   copies; idle share); then ``mnist`` (batch 32, 30 steps): the loss
   below 0.5 and eval top-1 above 0.7, as the JAX package's test holds;
4cd. convnets over four ranks — ``imagenet --mesh data=4 --zero1 true``
   through ``ring`` and ``ring_q8`` (global batch 128, 20 steps) and
   ``mnist --mesh data=4 --grad-sync ring`` (config #2, 30 steps, the
   loss below 0.5): finite losses, the replicas bit-identical, the ring
   launches (set to 0 just before) buckets x steps for the run's kinds
   and 0 for the others, the q8 ones on the forms the plan names;
4cp. the parameter server — ``mnist --mode parity --nranks 2`` (config
   #1: 40 steps, batch 32, the final loss below the first, eval accuracy
   above 0.5), ``mnist --mode parity --nranks 5 --easgd true
   --sync-every 4`` and ``imagenet --mode parity --nranks 5`` (config #3
   at full width, 2 steps a client): the copy kernel's launches (set to
   0 just before) exactly four a Downpour client step and four an EASGD
   exchange (each flat message a send snapshot and a delivery), the
   ``ps_msgs`` counters and the wall time reported;
5c. convnet parity — f32 (TF32 off, cuDNN deterministic, no autotuning),
   three goo SGD steps from one seeded port initialisation, LeNet and
   AlexNet at 128 x 128 with 8 classes, batch 32: ``ring`` losses within
   1e-5 relative of ``psum``'s at p 4, ``ring_q8`` within ``0.02 +
   0.02·|loss|`` (the JAX package's pin), one rank within 1e-4 relative
   of the four ranks (cuDNN's algorithms differ by batch size).
Their records go to ``chiprun_out/chip_smoke_convnets.json``; the
kernels line's ring and copy rows count their launches by run.

ResNet-50 (BASELINE.json's config #4). Phase 3e also holds the ring
kernels at its bucket plan over four ranks (7 buckets of its 49,924-row
shard: a full 8192-row bucket and the 772-row tail, read in place), both
kinds, sum and q8, bit for bit. Then, through ``resnet``'s ``main`` in
process and raising on failure:

4r. ResNet-50 on one rank — at full width (224 x 224, 1000 classes, the
   s2d stem, bf16 compute, f32 parameters and BatchNorm statistics, goo
   SGD lr 0.1 momentum 0.9 weight decay 1e-4, batch 128, 20 steps, seed
   0): finite losses and a finite eval (loss, top-1, top-5) through the
   running statistics; images/s at the step p50 (the host's data stream
   sets it), step p50/p95, peak memory; the same step over two batches
   made on the card, alternated, timed with CUDA events after five
   warm-up steps (its own peak memory), and profiled for three steps
   (device time by kernel family: convolutions, reductions, elementwise
   passes, copies, pooling, goo; idle share);
4rd. ResNet-50 over four ranks — ``--mesh data=4 --zero1 true`` through
   ``ring`` and ``ring_q8`` (32 images a rank, 10 steps), as 4cd checks
   its runs: finite losses, the replicas bit-identical (parameters and
   BatchNorm buffers), the ring launches (set to 0 just before) buckets x
   steps for the run's kinds and 0 for the others, the q8 ones on the
   forms the plan names;
5r. ResNet parity — f32 (TF32 off, cuDNN deterministic, no autotuning),
   three steps (lr 0.01) at 64 x 64 with 8 classes, eight images a rank
   over four: ``ring`` within 1e-5 relative of ``psum`` (losses) and
   1e-4 x max(1, max |x|) (every BatchNorm buffer), ``ring_q8`` within
   ``0.02 + 0.02·|loss|``; the replicas bit-identical in every mode.
Their records go to ``chiprun_out/chip_smoke_resnet.json``; the kernels
line's ring rows count 4rd's launches by run.

Checkpoints, the dense format and the elastic tier, in a temporary
directory deleted at the end:

4k. checkpoints and resume — ``mnist`` on one rank (20 steps) and
   ``imagenet`` (AlexNet at full width, batch 128) over four ranks
   through ``ring`` (8 steps), each with ``--ckpt-dir`` under 5c's
   settings: an uninterrupted run; a run stopped at N/2 by a SIGTERM that
   the main thread's own forward hook sends, which saves and exits
   resumable; its resumption to N. The resumed losses and rank 0's final
   parameters equal the uninterrupted run's bit for bit, the replicas
   equal, the ring launches buckets x steps in every run. Then each
   checkpoint's cost at full width (AlexNet over four ranks, GPT-2 small
   with Adam over four, and GPT-2's dense file): its bytes, the time a
   save holds the step (asynchronous and synchronous), ``wait()`` and
   ``restore``;
4kd. divergence restore — ``mnist`` with ``--ckpt-dir``, rank 0's input
   poisoned at one step: one restore, the run completes with finite
   losses, every checkpoint left holds finite values; poisoned twice with
   ``--max-restores 1``, ``Diverged`` is raised;
4kx. dense across geometry — GPT-2 small at full width (seq 512, batch
   8, the flash kernels) over four ranks (ZeRO-1, ``ring``): 6 steps
   uninterrupted; 3 with ``--save-dense``, continued on two ranks with
   ``--resume-dense`` to 6, within GPT2_DENSE_TOL of the uninterrupted
   run (ring launches buckets x steps at each p, flash 12 a rank and
   step); the final ``.npz`` through ``python -m mpit_tpu_torch.serve
   --ckpt``'s ``main`` (decode launches), its parameters bit-equal to the
   trained rank 0 model's, and f32 greedy tokens from it equal to those
   of an engine on the parameters in memory;
4e. the elastic tier — ``mnist --mode elastic --nranks 5`` (four LeNet
   replicas, 60 steps of 32 images each, an exchange every 4 steps,
   alpha 0.5 / N_active): healthy (no eviction; the loss falls: the
   centre's held-out eval loss below the initial parameters', and the
   median of replica 0's later logged losses below its first two), a kill
   with ``--ckpt-dir`` (crash, eviction, rejoin 5 steps back), a hang
   past the lease (evict, readmit) and a NaN (quarantine, restore,
   rejoin); in each the copy kernel's launches exactly 2 x (registers +
   rejoins) + 4 x exchanges, with events, version, wall time, steps/s,
   staleness and exchanges by replica, the step straggler and the eval
   on the centre reported; every replica's loss at every step and every
   exchange's version and staleness (``elastic_probe``, around the
   loss functions and ``AnchorClient.exchange``), each replica's jumps
   (losses past step 40 above 1.0), and PR 15's first gate (replica 0's
   last two logged losses against its first two) beside today's.
   ``elastic N`` also writes a summary over the N healthy runs.
Their records go to ``chiprun_out/chip_smoke_recovery.json``; the kernels
line's ring, flash and copy rows count their launches by run.

The last lines are the kernels JSON line (each decode form twice: at
T 1, its ``split`` body, and at its prefill width as ``<form>_prefill``,
each with the main path's launches of that body; the bf16 forms a third
time at the speculative verify's T = 5 as ``<form>_verify`` and the
matmul at its 40 rows as ``quantized_matmul_verify``, with phase 4s's
launches; the TP shapes as ``<form>_tp<p>``, ``<form>_tp<p>_prefill``,
``flash_decode_attention_tp2_verify`` and ``quantized_matmul_tp<p>_<layer>``,
with phase 4m's launches; the paged forms as ``<form>_policy`` and
``<form>_policy_prefill`` and the matmul as ``quantized_matmul_policy``,
with phase 4p's launches; the flash kernels in the tiers' forms as
``flash_<kind>_tp6``, ``_tp3``, ``_tp6_fsdp``, ``_ring_s<step>`` and
``_ulysses``, each with its run's launches at that geometry as the
counts read them (phases 4mt and 4sq); every number in it
but ``bound_ms`` measured in this run, so the earlier design's times,
``before_ms``, stay in the per-case records), the card's name and power
limit as ``nvidia-smi`` prints them, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "chiprun_out"

# The card's peaks, from the port's ChipSpec (H100 SXM data sheet: 3.35
# TB/s HBM, 989 TFLOP/s dense bf16, 67 TFLOP/s f32 outside the tensor
# cores), so the bounds here and the roofline share one source; set by
# load_peaks() once the port is imported.
HBM_BYTES_PER_S = None
PEAK_OPS_PER_S = None
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LSE_TOL = 1e-4  # the flash forward's f32 lse, in both dtypes
# Logits: the widest gap at which int8 greedy tokens may part from the
# dense reference (observed on an H100 at seed 0: 0.00014 and 0.0014;
# a wrong page or scale moves logits by tenths).
INT8_TIE = 0.01
# The widest gap (logits) at which bf16 greedy tokens from two schedules
# of the same model may part. bf16 activations are rounded at every
# layer, so where the two schedules round differently the logits move by
# about 1e-2, where INT8_TIE was set for f32's last-bit differences. 4m:
# each TP rank's bf16 partial is rounded before the sum (first seen on an
# H100: partings at gaps of 0.0017-0.0121). 4p: a recompute resume takes
# the generated tokens' K/V from prefill chunks where the closed-loop run
# took them from ticks (one-sided gaps up to 0.0147 seen on an H100). A
# wrong shard, head or scale, or a shifted resume feed, moves them by
# tenths; one wrong token in a resume feed stayed within 0.0086 in bf16,
# so 5m holds the f32 TP engines to the one-rank tokens exactly, and 4p's
# f32 run holds the recompute resume within F32_TIE (it parted that
# feed's requests at 0.0067-0.018).
BF16_TIE = 0.05
B, H, DH = 8, 12, 64  # GPT-2 small's head geometry, 8 slots
SERVE_ARGS = [
    "--model", "small", "--slots", "8", "--max-len", "512",
    "--prefill-len", "128", "--prompt-len", "128", "--requests", "16",
    "--max-new-tokens", "32", "--seed", "0",
]
PAGED_ARGS = ["--kv-pages", "256", "--kv-page-size", "16", "--prefill-chunk", "64"]
INT8W_ARGS = ["--weights-dtype", "int8"]
# The dense layers' (D, F) at GPT-2 small's width (qkv, proj, fc, out),
# the row counts the serve runs give them (decode tick, paged prefill
# chunk, dense prefill), and one shape ragged in every dimension.
QMM_SHAPES = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]
QMM_ROWS = (8, 512, 1024)
# The plan's edges, bf16 only: one row, the decode tile's last row count
# and the first past it, a 64-row block.
QMM_EDGE_ROWS = (1, 9, 64)
QMM_RAGGED = (5, 100, 130)
QMM_TOL = 1e-4  # times max(1, max |plain|)
# The same cases' times (ms) under the earlier design (qmm_kernel<X> on f32
# FMAs, 8 rows of x a block, no split): this script on an NVIDIA H100 80GB
# HBM3 at 700 W, the tree of commit 5ab586c (its last call). Keyed by (x
# dtype, M, D, F); the ragged row is M 5 alone.
BEFORE_QMM_MS = {
    **{("bfloat16", m, d, f): ms for (d, f), row in {
        (768, 2304): (0.0229, 0.1319, 0.2513), (768, 768): (0.0201, 0.0494, 0.0919),
        (768, 3072): (0.0192, 0.1728, 0.3330), (3072, 768): (0.0563, 0.1580, 0.3102),
    }.items() for m, ms in zip(QMM_ROWS, row)},
    **{("float32", m, d, f): ms for (d, f), row in {
        (768, 2304): (0.0193, 0.1322, 0.2523), (768, 768): (0.0195, 0.0499, 0.0927),
        (768, 3072): (0.0193, 0.1722, 0.3344), (3072, 768): (0.0555, 0.1591, 0.3113),
    }.items() for m, ms in zip(QMM_ROWS, row)},
    ("bfloat16", *QMM_RAGGED): 0.0118, ("float32", *QMM_RAGGED): 0.0130,
}
FLASH_B, FLASH_T = 8, (512, 1024)  # GPT-2 small's training batch and lengths
TRAIN_ARGS = ["--flash", "true", "--steps", "30", "--log-every", "1"]
TRAIN_PARITY_TOL = 1e-4  # relative, per-step loss, f32
# Phase 3e: rank counts, and a chunk of GPT-2 small's 4 MiB f32 bucket.
RING_P = (2, 4, 8)
RING_ROWS = 8192
# Phases 4d and 5d: phase 4t's run over four ranks on the one card.
DP_RANKS = 4
DP_ARGS = TRAIN_ARGS + ["--mesh", f"data={DP_RANKS}", "--zero1", "true"]
DP_PARITY_TOL = 1e-5  # relative, per-step loss, f32, ring vs psum
# Phase 3f: GPT-2 small's layers and a 128-row shipment's payloads
# (bf16 k and v; int8 k.q, k.scale, v.q, v.scale).
L_SMALL, SHIP_ROWS = 12, 128
SHIP_PAYLOADS = {
    "payload bf16": 2 * L_SMALL * SHIP_ROWS * H * DH * 2,
    "payload int8": 2 * (L_SMALL * SHIP_ROWS * H * DH + L_SMALL * SHIP_ROWS * H * 4),
}
# Phases 4c, 4cd, 4cp and 5c: the convnet workloads of BASELINE.json's
# configs #1-#3 (LeNet on MNIST, AlexNet on ImageNet), four ranks or five
# parity ranks on the one card. AlexNet's defaults are the workload's own:
# 224 x 224, 1000 classes, bf16 compute, f32 parameters, goo SGD at lr 0.01
# with momentum 0.9.
CONV_RANKS = 4
IMAGENET_ARGS = ["--batch-size", "128", "--eval-batch", "128", "--log-every", "1"]
IMAGENET_STEPS, IMAGENET_DP_STEPS = 30, 20
MNIST_ARGS = ["--steps", "30", "--batch-size", "32", "--log-every", "10"]
ALEXNET_FLAT = 61_101_056  # the flat layout of AlexNet's 61,100,840 parameters
CONV_PARITY_TOL = 1e-5  # relative, per-step loss, f32, ring vs psum
# Relative, per-step loss, f32: one rank against four on the same global
# batch. The four ranks' mean of means equals the one rank's mean up to
# rounding, but cuDNN picks its algorithms by batch size, so the sums
# run in other orders; three steps at lr 0.01-0.05 carry that through.
CONV_RANKS_TOL = 1e-4
# Phases 4r, 4rd and 5r: ResNet-50 (BASELINE.json's config #4) at its
# defaults, the workload's own: 224 x 224, 1000 classes, the s2d stem,
# bf16 compute, f32 parameters and statistics, goo SGD at lr 0.1 with
# momentum 0.9 and weight decay 1e-4; batch 128 on one rank, 32 a rank
# over four.
RESNET_ARGS = ["--batch-size", "128", "--eval-batch", "128", "--log-every", "1"]
RESNET_STEPS, RESNET_DP_STEPS = 20, 10
RESNET_FLAT = 25_560_832  # the flat layout of ResNet-50's 25,559,912 parameters
# 5r: f32, three steps at 64 x 64 with 8 classes, eight images a rank,
# lr 0.01. Relative, per-step loss, ring against psum (the ring sums the
# ranks in another order, and the norms' gradients carry the difference).
RESNET_PARITY_TOL = 1e-5
# The same, for every BatchNorm buffer after the three steps: times
# max(1, max |psum's|).
RESNET_STATS_TOL = 1e-4
# Phase 4f: the JAX package's test liveness (no spurious evictions).
FLEET_LIVENESS = "heartbeat_s=0.05,lease_s=5.0"
FORMS = (
    "flash_decode_attention",
    "flash_decode_attention_int8",
    "flash_paged_decode_attention",
    "flash_paged_decode_attention_int8",
)
# The same cases' kernel times (ms) under the earlier design, so that every
# case's record holds it beside its own: this script on an NVIDIA H100 80GB
# HBM3 at 700 W (its chiprun_out/chip_smoke_kernels.json). For the bf16 and
# f32 K/V forms, the tree of commit 34f96eb, before the decode kernel's
# split and mma bodies; for the int8 forms, the tree of commit 5552d17,
# before the q8mma body (its T > 1 cases ran the rows body, its T = 1 cases
# the split body they run now). Keyed by T, then (S 512, S 1024).
BEFORE_DECODE_MS = {  # (form, q dtype, page size): {T: (S 512, S 1024)}
    ("flash_decode_attention", "bfloat16", None): {1: (0.0428, 0.0683), 128: (0.2605, 0.4628)},
    ("flash_decode_attention", "float32", None): {1: (0.0306, 0.0539), 128: (0.2251, 0.3946)},
    ("flash_paged_decode_attention", "bfloat16", 16): {1: (0.0362, 0.0655), 64: (0.1114, 0.2130)},
    ("flash_paged_decode_attention", "bfloat16", 64): {1: (0.0362, 0.0657), 64: (0.1117, 0.2119)},
    ("flash_paged_decode_attention", "float32", 16): {1: (0.0420, 0.0663), 64: (0.1073, 0.2042)},
    ("flash_paged_decode_attention", "float32", 64): {1: (0.0364, 0.0647), 64: (0.1066, 0.2041)},
    ("flash_decode_attention_int8", "bfloat16", None): {
        1: (0.0135, 0.0189), 64: (0.1534, 0.2989), 128: (0.3248, 0.5712)},
    ("flash_decode_attention_int8", "float32", None): {
        1: (0.0134, 0.0224), 64: (0.1537, 0.2995), 128: (0.3254, 0.5742)},
    ("flash_paged_decode_attention_int8", "bfloat16", 16): {1: (0.0157, 0.0225), 64: (0.1682, 0.3242)},
    ("flash_paged_decode_attention_int8", "bfloat16", 64): {1: (0.0160, 0.0225), 64: (0.1680, 0.3249)},
    ("flash_paged_decode_attention_int8", "float32", 16): {1: (0.0184, 0.0234), 64: (0.1692, 0.3253)},
    ("flash_paged_decode_attention_int8", "float32", 64): {1: (0.0155, 0.0228), 64: (0.1694, 0.3248)},
}
# The flash kernels' cases on the tree of commit 34f96eb, before the
# tensor-core forward, dk/dv and dq (the f32 kernels are unchanged since).
BEFORE_FLASH_MS = {  # (dtype, T, q_offset, k_offset, g_lse, fused): fwd, dq, dkv
    ("bfloat16", 512, 0, 0, False, False): (0.2038, 0.2726, 0.3410),
    ("bfloat16", 1024, 0, 0, False, False): (0.6182, 0.8732, 1.1078),
    ("float32", 512, 0, 0, False, False): (0.2041, 0.2722, 0.3492),
    ("float32", 1024, 0, 0, False, False): (0.6377, 0.8769, 1.1458),
    ("bfloat16", 512, 256, 0, False, False): (0.2646, 0.3749, 0.4688),
    ("bfloat16", 512, 0, 512, False, False): (0.0121, 0.0187, 0.0190),
    ("bfloat16", 512, 0, 0, True, False): (0.2062, 0.2749, 0.3393),
    ("bfloat16", 512, 0, 0, False, True): (0.2009, 0.2729, 0.3414),
}


def before_decode_ms(form: str, dtype: str, ps, s: int, t: int) -> float:
    return BEFORE_DECODE_MS[(form, dtype, ps)][t][s == 1024]


def decode_call(torch, da, form: str, path: str, fn):
    """``fn()`` once, checking that it launched ``form`` on the body
    ``path`` and nothing else; returns its result."""
    before = dict(da.path_launches)
    out = fn()
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in da.path_launches.items() if n != before[k]}
    if ran != {f"{form}/{path}": 1}:
        fail(f"{form}: expected one launch on the {path} body, got {ran}")
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_peaks() -> None:
    global HBM_BYTES_PER_S, PEAK_OPS_PER_S
    from mpit_tpu_torch.utils.profiling import H100_SXM

    HBM_BYTES_PER_S = H100_SXM.hbm_bandwidth
    PEAK_OPS_PER_S = {"bfloat16": H100_SXM.peak_flops_bf16, "float32": H100_SXM.peak_flops_f32}


_SEEDED = {}  # (config, seed) -> a seeded GPT-2's state_dict, on the host


def seeded_gpt2_state(torch, cfg, seed: int) -> dict:
    """The ``state_dict`` of ``GPT2(cfg, generator=manual_seed(seed))``,
    drawn once for each config and seed (the CPU's normals take seconds
    a model) and handed out as a fresh copy each time."""
    from mpit_tpu_torch.models import GPT2

    key = (repr(cfg), seed)
    if key not in _SEEDED:
        _SEEDED[key] = GPT2(cfg, generator=torch.Generator().manual_seed(seed)).state_dict()
    return {n: t.clone() for n, t in _SEEDED[key].items()}


def import_port():
    """The port from THIS checkout, nothing else."""
    sys.path.insert(0, str(HERE))
    try:
        import mpit_tpu_torch
    except ImportError as e:
        fail(f"mpit_tpu_torch is not beside chip_smoke.py ({e})")
    if Path(mpit_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"mpit_tpu_torch imported from {mpit_tpu_torch.__file__}, not {HERE}")


def cold_time_ms(fn, torch, flush, iters: int = 20, lead_cycles: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, each on a cold L2
    (a 256 MB buffer is rewritten before every timed call). For a call
    of several launches the time between its events includes any wait
    for the host between them. With ``lead_cycles`` the device spins that
    many cycles (``torch.cuda._sleep``) between the flush and the start
    event, so the host has queued the call's first launch before the event
    fires: the wrapper's host time before its launch is then left out."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# Device cycles of the spin before a ``device_ms`` start event (about
# 0.1 ms at the H100's 1.98 GHz).
HOST_LEAD_CYCLES = 200_000


def host_time_ms(fn, torch, iters: int = 20) -> float:
    """Mean host time of one call of ``fn`` (its wrapper's checks,
    allocations, pointer tables and launch), the calls queued back to back
    without a wait for the card."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s * 1e3 / iters


def warm_up(torch, seconds: float = 1.0) -> None:
    """Keep the card busy for about ``seconds`` before the first timed
    case, so that no case is timed while the clocks ramp up from idle;
    and run the device spin of ``cold_time_ms``'s ``lead_cycles`` once,
    so that its first call's one-off cost falls outside any timing."""
    a = torch.randn(4096, 4096, device="cuda")
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        torch.mm(a, a)
        torch.cuda.synchronize()


def bound(torch, lens, t: int, s: int, kv_row_bytes: float, q, extra_bytes=0):
    """The least time the card could take: the visible K and V rows
    (``min(L + T, S)`` per slot, at their wire size), q, o, lengths and
    visited once each (plus ``extra_bytes``: the block-table rows) over
    the HBM rate, against 4 operations per (query, visible key, dim)
    over q's peak rate. Returns ``(bound_ms, bound_by)``."""
    visible = (lens.long() + t).clamp(max=s)
    nbytes = (
        2 * int(visible.sum()) * kv_row_bytes
        + 2 * q.numel() * q.element_size() + 2 * 4 * lens.numel() + extra_bytes
    )
    h, d = q.shape[2:]
    nops = 4 * h * d * int(
        (lens.long()[:, None] + torch.arange(1, t + 1, device=lens.device))
        .clamp(max=s).sum()
    )
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[str(q.dtype).removeprefix("torch.")] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa_call(torch, q, k, v, lens):
    """``scaled_dot_product_attention`` over dense ``[B, S, H, Dh]`` K/V
    with the kernel's visibility mask, as a zero-argument call."""
    import torch.nn.functional as F

    t, s = q.shape[1], k.shape[1]
    q_pos = lens.long()[:, None] + torch.arange(t, device=q.device)
    mask = (torch.arange(s, device=q.device) <= q_pos[..., None])[:, None]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def kernel_phase(torch, flush):
    """Phase 3: the dense flash-decode kernel against its plain version."""
    from mpit_tpu_torch.ops import decode_attention as da

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in (512, 1024):
            for t in (1, 128):
                gen = torch.Generator(device="cuda").manual_seed(s + t)
                q, k, v = (
                    torch.randn(shape, generator=gen, device="cuda").to(dtype)
                    for shape in ((B, t, H, DH), (B, s, H, DH), (B, s, H, DH))
                )
                lens = torch.linspace(0, s - t, B, device="cuda").int()
                bk = da.pick_block_k(s)
                path = da._decode_path(dtype, dtype, t)
                out, visited = decode_call(
                    torch, da, "flash_decode_attention", path,
                    lambda: da.flash_decode_attention(q, k, v, lens, return_visited=True),
                )
                ref = da.reference_decode_attention(q, k, v, lens)
                err = (out.float() - ref.float()).abs().max().item()
                name = str(dtype).removeprefix("torch.")
                if not math.isfinite(err) or err > TOL[name]:
                    fail(f"kernel vs plain {name} S={s} T={t}: {err} > {TOL[name]}")
                want = da.num_kv_blocks(lens.cpu(), t, s, bk)
                if not torch.equal(visited.cpu(), want):
                    fail(f"visited {visited.tolist()} != num_kv_blocks {want.tolist()}")
                bound_ms, bound_by = bound(torch, lens, t, s, H * DH * q.element_size(), q)
                cases.append({
                    "form": "flash_decode_attention", "path": path,
                    "dtype": name, "kv": name, "B": B, "S": s, "T": t, "H": H,
                    "Dh": DH, "block_k": bk, "lengths": lens.tolist(),
                    "max_abs_err": err, "tol": TOL[name],
                    "before_ms": before_decode_ms("flash_decode_attention", name, None, s, t),
                    "ms": cold_time_ms(
                        lambda: da.flash_decode_attention(q, k, v, lens),
                        torch, flush,
                    ),
                    "plain_ms": cold_time_ms(
                        lambda: da.reference_decode_attention(q, k, v, lens),
                        torch, flush,
                    ),
                    "library_ms": cold_time_ms(sdpa_call(torch, q, k, v, lens), torch, flush),
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                })
                print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    return cases


def paged_kernel_phase(torch, flush):
    """Phase 3b: the paged and int8 forms against their plain versions."""
    from mpit_tpu_torch.models.gpt2 import paged_gather
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops.kv_quant import (
        QuantizedKV,
        dequantize_kv,
        kv_wire_bytes_per_row,
        quantize_kv,
    )

    def as_pool(x, ps):  # [B, S, H, Dh] (or QuantizedKV) -> pages in order
        if isinstance(x, QuantizedKV):
            return QuantizedKV(as_pool(x.q, ps), as_pool(x.scale, ps))
        return x.reshape(-1, ps, *x.shape[2:])

    cases = []
    layouts = [("dense", None)] + [("paged", ps) for ps in (16, 64)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for int8 in (False, True):
            for layout, ps in layouts:
                if layout == "dense" and not int8:
                    continue  # phase 3
                for s in (512, 1024):
                    # Dense int8 also at T 128, the dense serving runs' prefill.
                    for t in (1, 64) if layout == "paged" else (1, 64, 128):
                        seed = s + t + (ps or 0) + 7 * int8
                        gen = torch.Generator(device="cuda").manual_seed(seed)
                        q = torch.randn((B, t, H, DH), generator=gen, device="cuda").to(dtype)
                        lens = torch.linspace(0, s - t, B, device="cuda").int()
                        if layout == "paged":
                            n_ps = s // ps
                            p = B * n_ps + 1
                            k, v = (
                                torch.randn((p, ps, H, DH), generator=gen, device="cuda").to(dtype)
                                for _ in range(2)
                            )
                            if int8:
                                k, v = quantize_kv(k), quantize_kv(v)
                            perm = torch.randperm(
                                p, generator=torch.Generator().manual_seed(seed)
                            )[: B * n_ps]
                            bt = perm.reshape(B, n_ps).int()
                            bt[1, :2] = bt[0, :2]  # two slots share pages
                            bt = bt.cuda()
                            kd, vd = paged_gather(k, bt), paged_gather(v, bt)
                            bk = da.pick_block_k(ps)
                            run = lambda: da.flash_paged_decode_attention(  # noqa: E731
                                q, k, v, lens, bt, return_visited=True
                            )
                            plain = lambda: da.reference_paged_decode_attention(  # noqa: E731
                                q, k, v, lens, bt
                            )
                            form = "flash_paged_decode_attention"
                            extra = bt.numel() * 4
                        else:
                            k, v = (
                                quantize_kv(
                                    torch.randn((B, s, H, DH), generator=gen, device="cuda").to(dtype)
                                )
                                for _ in range(2)
                            )
                            kd, vd, bk = k, v, da.pick_block_k(s)
                            run = lambda: da.flash_decode_attention(  # noqa: E731
                                q, k, v, lens, return_visited=True
                            )
                            plain = lambda: da.reference_decode_attention(q, k, v, lens)  # noqa: E731
                            form, extra = "flash_decode_attention", 0
                        form += "_int8" if int8 else ""
                        label = f"{form} q={name} ps={ps} S={s} T={t}"
                        path = da._decode_path(dtype, torch.int8 if int8 else dtype, t)
                        out, visited = decode_call(torch, da, form, path, run)
                        err = (out.float() - plain().float()).abs().max().item()
                        if not math.isfinite(err) or err > TOL[name]:
                            fail(f"kernel vs plain {label}: {err} > {TOL[name]}")
                        want = da.num_kv_blocks(lens.cpu(), t, s, bk)
                        if not torch.equal(visited.cpu(), want):
                            fail(f"{label}: visited {visited.tolist()} != {want.tolist()}")
                        if layout == "paged":
                            # The pre-gathered dense view, mapped in order.
                            ident = torch.arange(B * n_ps, dtype=torch.int32, device="cuda")
                            paged_id = da.flash_paged_decode_attention(
                                q, as_pool(kd, ps), as_pool(vd, ps), lens,
                                ident.reshape(B, n_ps),
                            )
                            dense = decode_call(
                                torch, da, form.replace("_paged", ""), path,
                                lambda: da.flash_decode_attention(q, kd, vd, lens, block_k=bk),
                            )
                            if not torch.equal(paged_id, dense):
                                fail(f"{label}: identity-mapped paged != dense kernel ({path})")
                        if int8:
                            kd, vd = dequantize_kv(kd).to(dtype), dequantize_kv(vd).to(dtype)
                        row = kv_wire_bytes_per_row(H, DH, torch.int8 if int8 else dtype)
                        bound_ms, bound_by = bound(torch, lens, t, s, row, q, extra)
                        cases.append({
                            "form": form, "path": path, "dtype": name,
                            "kv": "int8" if int8 else name, "page_size": ps,
                            "B": B, "S": s, "T": t, "H": H, "Dh": DH,
                            "block_k": bk, "max_abs_err": err, "tol": TOL[name],
                            "before_ms": before_decode_ms(form, name, ps, s, t),
                            "ms": cold_time_ms(run, torch, flush),
                            "plain_ms": cold_time_ms(plain, torch, flush),
                            "library_ms": cold_time_ms(
                                sdpa_call(torch, q, kd, vd, lens), torch, flush
                            ),
                            "bound_ms": bound_ms, "bound_by": bound_by,
                        })
                        print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    return cases


def qmm_bound(m: int, d: int, f: int, x) -> tuple[float, str]:
    """The least time for ``x[M, D] @ (q[D, F] * s[D])``: x, the int8
    weight, its f32 scales and the f32 output once each over the HBM
    rate, against 2 M D F operations over x's peak rate."""
    nbytes = m * d * x.element_size() + d * f + 4 * d + 4 * m * f
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * d * f / PEAK_OPS_PER_S[str(x.dtype).removeprefix("torch.")] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def qmm_kernel_phase(torch, flush):
    """Phase 3c: the fused-dequant matmul kernel against its plain version."""
    from mpit_tpu_torch.ops import quantized_matmul as qm

    shapes = [(m, d, f) for d, f in QMM_SHAPES for m in QMM_ROWS] + [QMM_RAGGED]
    edges = [(m, d, f) for d, f in QMM_SHAPES for m in QMM_EDGE_ROWS]
    cases = []
    # As before phase 3: no case is timed while the clocks ramp up or a
    # collection of phase 3b's garbage runs (without this the first case
    # read slow in this script's runs).
    gc.collect()
    warm_up(torch, 0.5)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        for m, d, f in shapes + (edges if dtype == torch.bfloat16 else []):
            gen = torch.Generator(device="cuda").manual_seed(m + d + f)
            x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
            w = qm.quantize_tensor(
                torch.randn((d, f), generator=gen, device="cuda") / math.sqrt(d)
            )
            label = f"quantized_matmul x={name} M={m} D={d} F={f}"
            plan = qm.kernel_plan(m, d, f, dtype, x.device)
            paths = dict(qm.path_launches)
            out = qm.quantized_matmul(x, w)
            torch.cuda.synchronize()
            ran = {k: n - paths[k] for k, n in qm.path_launches.items() if n != paths[k]}
            if ran != {plan["path"]: 1}:
                fail(f"{label}: launches by body {ran}, expected one on {plan['path']}")
            plain = qm.quantized_matmul_plain(x, w)
            err = (out - plain).abs().max().item()
            tol = QMM_TOL * max(1.0, plain.abs().max().item())
            if out.dtype != torch.float32 or not math.isfinite(err) or err > tol:
                fail(f"kernel vs plain {label}: {err} > {tol} ({out.dtype})")
            w_deq = qm.dequantize_tensor(w)  # the yardstick's, not timed
            run = lambda: qm.quantized_matmul(x, w)  # noqa: E731
            lib = lambda: torch.matmul(x.float(), w_deq)  # noqa: E731
            bound_ms, bound_by = qmm_bound(m, d, f, x)
            cases.append({
                "form": "quantized_matmul", "dtype": name, "M": m, "D": d, "F": f,
                "path": plan["path"], "tile": list(plan["tile"]), "splits": plan["splits"],
                "blocks": plan["blocks"],
                "max_abs_err": err, "tol": tol,
                "before_ms": BEFORE_QMM_MS.get((name, m, d, f)),
                "ms": cold_time_ms(run, torch, flush),
                "plain_ms": cold_time_ms(
                    lambda: qm.quantized_matmul_plain(x, w), torch, flush
                ),
                "library_ms": cold_time_ms(lib, torch, flush),
                # As for the ring cases: the same two calls with their host
                # time before the launch left out, and the wrapper's host
                # time a call.
                "device_ms": cold_time_ms(run, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
                "library_device_ms": cold_time_ms(lib, torch, flush,
                                                  lead_cycles=HOST_LEAD_CYCLES),
                "host_ms": host_time_ms(run, torch),
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
            print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    return cases


def serve_phase(torch, card, extra_args, form, records):
    """Phase 4: the port's serving main path at GPT-2 small's width,
    through the attention kernel ``form`` and, with ``--weights-dtype
    int8``, the matmul kernel (every launch count read around the run).
    Appends the run's record to ``records``; returns ``(attention
    launches, matmul launches, attention launches by body, matmul
    launches by body)``."""
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.serve.__main__ import main

    da.launches.update(dict.fromkeys(da.launches, 0))
    da.path_launches.update(dict.fromkeys(da.path_launches, 0))
    qm.launches.update(dict.fromkeys(qm.launches, 0))
    qm.path_launches.update(dict.fromkeys(qm.path_launches, 0))
    out = main(SERVE_ARGS + extra_args)
    counts = dict(da.launches)
    paths = {k: n for k, n in da.path_launches.items() if n}
    qmm_launches = qm.launches["quantized_matmul"]
    qmm_paths = {k: n for k, n in qm.path_launches.items() if n}
    launches = counts[form]
    phases = out["obs_summary"]
    n_prefill = phases["prefill"]["count"]
    n_decode = phases["decode"]["count"]
    need = out["model"]["layers"] * (n_prefill + n_decode)
    tag = " ".join(extra_args) or "dense"
    if out["requests_completed"] != 16 or out["truncated"]:
        fail(f"serve {tag}: {out['requests_completed']} of 16 requests completed")
    if out["generated_tokens"] != 16 * 32:
        fail(f"serve {tag}: {out['generated_tokens']} tokens, expected {16 * 32}")
    if launches < need or launches == 0:
        fail(f"serve {tag}: {launches} {form} launches < {need} (layers x calls)")
    if any(n for f, n in counts.items() if f != form):
        fail(f"serve {tag}: other kernel forms launched: {counts}")
    # Every prefill (T > 1, bf16 q) on a tensor-core body, mma for bf16 K/V
    # and q8mma for int8 K/V; every decode tick (T = 1) on the split body.
    layers = out["model"]["layers"]
    prefill_path = "q8mma" if form.endswith("_int8") else "mma"
    want_paths = {f"{form}/{prefill_path}": layers * n_prefill, f"{form}/split": layers * n_decode}
    if paths != want_paths:
        fail(f"serve {tag}: launches by body {paths}, expected {want_paths}")
    int8w = "--weights-dtype" in extra_args
    if int8w and qmm_launches < 4 * need:
        fail(f"serve {tag}: {qmm_launches} quantized_matmul launches < {4 * need} "
             "(4 dense layers x layers x calls)")
    # bf16 activations: every matmul launch on the tensor-core body.
    if int8w and qmm_paths != {"mma": qmm_launches}:
        fail(f"serve {tag}: quantized_matmul launches by body {qmm_paths}, "
             f"expected all {qmm_launches} on mma")
    if not int8w and qmm_launches:
        fail(f"serve {tag}: quantized_matmul launched {qmm_launches} times "
             "without --weights-dtype int8")
    if out["decode_attention"] != "kernel" or out["device"] != "cuda":
        fail(f"serve ran {out['decode_attention']} on {out['device']}")
    keys = (
        "model", "device", "wall_s", "decode_tokens_per_sec",
        "requests_completed", "generated_tokens", "ticks", "admissions",
        "ttft_p50_s", "ttft_p95_s", "latency_p50_s", "latency_p95_s",
        "kv_dtype", "weights_dtype", "kv_page_size", "kv_pool_pages",
        "kv_pool_occupancy_mean",
        "kv_pool_occupancy_peak", "prefix_hit_rate", "prefix_hits",
        "prefix_pages_shared_peak", "kv_cow_copies", "concurrency_peak",
    )
    records.append({
        "card": card,
        "serve": {k: out[k] for k in keys if k in out},
        "args": extra_args,
        "prefill_calls": n_prefill,
        "decode_ticks": n_decode,
        "prefill_ms_p50": phases["prefill"]["p50_s"] * 1e3,
        "prefill_ms_p95": phases["prefill"]["p95_s"] * 1e3,
        "decode_tick_ms_p50": phases["decode"]["p50_s"] * 1e3,
        "decode_tick_ms_p95": phases["decode"]["p95_s"] * 1e3,
        "kernel_form": form,
        "kernel_launches": launches,
        "kernel_launches_by_body": paths,
        "quantized_matmul_launches": qmm_launches,
        "quantized_matmul_launches_by_body": qmm_paths,
    })
    print(json.dumps(records[-1]), flush=True)
    return launches, qmm_launches, paths, qmm_paths


def int8w_serve_profile(torch, ticks: int = 8) -> dict:
    """Phase 4q: one prefill call and ``ticks`` decode ticks of phase 4's
    dense int8-weight engine under ``torch.profiler`` (see
    :func:`profile_window`), each window apart."""
    import numpy as np

    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.serve.__main__ import ServeConfig, _build_engine

    cfg = from_argv(ServeConfig, SERVE_ARGS + INT8W_ARGS)
    engine, mcfg = _build_engine(cfg)
    slots = cfg.slots
    tokens = np.random.default_rng(cfg.seed).integers(
        0, mcfg.vocab_size, (slots, cfg.prefill_len))
    lens = np.full(slots, cfg.prefill_len, np.int32)
    every = np.ones(slots, bool)
    temp, topk = np.zeros(slots, np.float32), np.zeros(slots, np.int32)

    def prefill(_):
        engine.prefill(tokens, lens, every, temp, topk)

    def tick(_):
        engine.decode(every, temp, topk)

    prefill(None)  # the first launches' one-off costs, outside the windows
    tick(None)
    engine.reset()
    out = {"prefill_call": profile_window(torch, prefill, [None]),
           "decode_tick": profile_window(torch, tick, list(range(ticks)))}
    del engine
    torch.cuda.empty_cache()
    return out


def parity_phase(torch):
    """Phase 5: f32 greedy tokens, dense kernel engine vs reference engine.
    Returns the config, the state and the kernel engine's tokens."""
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.models import GPT2Config
    from mpit_tpu_torch.serve import Engine, Server
    from mpit_tpu_torch.serve.__main__ import ServeConfig, synthetic_requests

    cfg = from_argv(ServeConfig, SERVE_ARGS)
    mcfg = GPT2Config.small(dtype=torch.float32)
    state = seeded_gpt2_state(torch, mcfg, cfg.seed)
    tokens = {}
    for mode in ("kernel", "reference"):
        engine = Engine(
            mcfg, state, slots=cfg.slots, max_len=cfg.max_len,
            prefill_len=cfg.prefill_len, seed=cfg.seed, device="cuda",
            decode_attention=mode,
        )
        server = Server(engine)
        for req in synthetic_requests(cfg, mcfg.vocab_size):
            server.submit(req)
        tokens[mode] = {c.rid: c.tokens for c in server.run()}
        del engine, server
        torch.cuda.empty_cache()
    diff = [r for r in tokens["reference"] if tokens["kernel"].get(r) != tokens["reference"][r]]
    if len(tokens["reference"]) != 16 or diff:
        fail(f"f32 greedy tokens differ, kernel vs reference, for requests {diff}")
    print(json.dumps({"parity_f32": "identical", "requests": 16,
                      "tokens": sum(len(t) for t in tokens["kernel"].values())}),
          flush=True)
    return mcfg, state, tokens["kernel"]


def shared_prefix_stream(vocab: int, seed: int = 0):
    """16 greedy requests in two waves. The first wave holds two prompts
    of 37 and 50 tokens (whole pages plus a partial one), one request
    behind a 70-token system prompt (4 pages of 16 plus 6 tokens) and a
    long prompt of its own; the second, submitted a few ticks later,
    repeats the two prompts (full-prompt reuse: the copy-on-write
    happens at the first decode append), then 7 more system-prompt
    requests and 3 more of their own. Prompts of 110 to 200 tokens keep
    the 48-page pool the limit, not the 8 slots."""
    import numpy as np

    from mpit_tpu_torch.serve import Request

    rng = np.random.RandomState(seed)
    toks = lambda n: rng.randint(0, vocab, n).tolist()  # noqa: E731
    sysp, pa, pb = toks(70), toks(37), toks(50)
    own = lambda i: Request(rid=f"own{i}", prompt=toks(rng.randint(100, 201)), max_new_tokens=32)  # noqa: E731
    sys_ = lambda i: Request(  # noqa: E731
        rid=f"sys{i}", prompt=sysp + toks(rng.randint(40, 101)), max_new_tokens=32
    )
    first = [
        Request(rid="a0", prompt=pa, max_new_tokens=32),
        Request(rid="b0", prompt=pb, max_new_tokens=32),
        sys_(0), own(0),
    ]
    later = [
        Request(rid="a1", prompt=pa, max_new_tokens=24),
        Request(rid="b1", prompt=pb, max_new_tokens=24),
    ] + [sys_(i) for i in range(1, 8)] + [own(i) for i in range(1, 4)]
    return first, later


def run_stream(engine, first, later, wave_tick: int = 3):
    from mpit_tpu_torch.serve import Server

    server = Server(engine)
    for req in first:
        server.submit(req)
    server.run(max_ticks=wave_tick)
    for req in later:
        server.submit(req)
    return {c.rid: c for c in server.run()}, server


def report_divergence(torch, model, prompt, got, want):
    """First diverging token of one request and the reference logit
    margin (top-1 minus top-2) at that position."""
    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = torch.tensor([prompt + want[:i]], device="cuda")
    with torch.no_grad():
        logits = model(seq)[0, -1].float()
    top = logits.topk(2).values
    return {"token_index": i, "got": got[i], "want": want[i],
            "logit_margin": (top[0] - top[1]).item()}


def int8_divergence(torch, model, prompt, got, want):
    """First diverging token of one int8 request, judged by the plain
    int8 path teacher-forced on the reference's tokens (one cached
    forward: quantize on write, dequantized plain attention): the gap
    between the reference's and the kernel engine's token there, and
    the top-1 minus top-2 margin."""
    from mpit_tpu_torch.serve.kvcache import alloc_cache

    i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
    seq = prompt + want[:i]
    c = alloc_cache(model.cfg, 1, len(seq), device="cuda", quantized=True)
    with torch.no_grad():
        logits, _ = model(torch.tensor([seq], device="cuda"), cache=(c.k, c.v, c.lengths))
    row = logits[0, -1].float()
    top = row.topk(2).values
    return {"token_index": i, "got": got[i], "want": want[i],
            "gap": (row[want[i]] - row[got[i]]).item(),
            "logit_margin": (top[0] - top[1]).item()}


def gemm_rows_stable(torch) -> dict:
    """For each row count m: whether the rows of ``X[:m] @ W`` equal,
    bit for bit, the same rows of ``X @ W`` (f32, 2048 x 768 @ 768 x
    2304, GPT-2 small's QKV projection) — what keeps two prefill
    schedules' K/V identical."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn(768, 2304, generator=gen, device="cuda")
    x = torch.randn(2048, 768, generator=gen, device="cuda")
    full = x @ w
    return {m: torch.equal(x[:m] @ w, full[:m]) for m in (64, 256, 1024)}


def paged_parity_phase(torch, mcfg, state):
    """Phase 5b: the shared-prefix stream, paged kernel engine vs dense
    reference engine, f32 and int8 K/V."""
    from mpit_tpu_torch import obs
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.serve import Engine

    geo = dict(slots=8, max_len=512, prefill_len=256, seed=0, device="cuda")
    pool_geo = dict(kv_pages=48, kv_page_size=16, prefill_chunk=64)
    model = GPT2(mcfg, device="cuda")
    model.load_state_dict(state)
    results = {}
    for kv_dtype in (None, "int8"):
        first, later = shared_prefix_stream(mcfg.vocab_size)
        rec = obs.enable(obs.Recorder())
        try:
            engine = Engine(
                mcfg, state, decode_attention="kernel", kv_dtype=kv_dtype,
                **pool_geo, **geo,
            )
            paged, server = run_stream(engine, first, later)
        finally:
            obs.disable()
        alloc = engine.allocator
        waited = rec.summary().get("instants", {}).get("kv_pool_exhausted", 0)
        pool = {
            "prefix_hits": alloc.prefix_hits, "cow_copies": alloc.cow_copies,
            "admissions_waited_on_pages": waited,
            "shared_tokens": alloc.shared_tokens_total,
            "concurrency_peak": server.stats()["concurrency_peak"],
        }
        del engine, server
        ref_engine = Engine(
            mcfg, state, decode_attention="reference", kv_dtype=kv_dtype, **geo
        )
        dense, _ = run_stream(ref_engine, *shared_prefix_stream(mcfg.vocab_size))
        del ref_engine
        torch.cuda.empty_cache()
        tag = kv_dtype or "f32"
        if len(paged) != 16 or len(dense) != 16:
            fail(f"shared-prefix {tag}: {len(paged)} / {len(dense)} of 16 completed")
        diff = [r for r in dense if paged[r].tokens != dense[r].tokens]
        if kv_dtype is None and diff:
            r = diff[0]
            info = report_divergence(
                torch, model, dense[r].prompt, paged[r].tokens, dense[r].tokens
            )
            fail(f"shared-prefix {tag}: paged kernel vs dense reference differ "
                 f"for {diff}; first: {r} {info}")
        if not (pool["prefix_hits"] >= 1 and pool["cow_copies"] >= 1 and waited >= 1):
            fail(f"shared-prefix {tag}: the stream did not exercise the pool: {pool}")
        tokens = "identical"
        if kv_dtype == "int8":
            ties = {
                r: int8_divergence(torch, model, dense[r].prompt, paged[r].tokens,
                                   dense[r].tokens)
                for r in diff
            }
            wide = {r: d for r, d in ties.items() if not abs(d["gap"]) <= INT8_TIE}
            if wide:
                fail(f"shared-prefix int8: paged kernel vs dense reference part "
                     f"beyond a near-tie (|gap| > {INT8_TIE}): {wide}")
            # The plain version at the kernel engine's schedule, for the record.
            plain_engine = Engine(
                mcfg, state, decode_attention="reference", kv_dtype=kv_dtype,
                **pool_geo, **geo,
            )
            plain, _ = run_stream(plain_engine, *shared_prefix_stream(mcfg.vocab_size))
            del plain_engine
            torch.cuda.empty_cache()
            tokens = {
                "identical_requests": 16 - len(diff),
                "near_ties": ties,
                "plain_paged_vs_plain_dense_differ": sorted(
                    r for r in dense if plain[r].tokens != dense[r].tokens
                ),
                "gemm_rows_stable": gemm_rows_stable(torch),
            }
        results[tag] = {"tokens": tokens, **pool}
    print(json.dumps({"parity_shared_prefix": results}), flush=True)


def int8w_parity_phase(torch, mcfg, state):
    """Phase 5c: PR 1's stream with int8 weights, dense kernel engine vs
    dense reference engine: f32 K/V identical, int8 K/V to the
    ``INT8_TIE`` rule. Divergences are judged by the plain int8-weight
    model (whole-weight dequant)."""
    import dataclasses

    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.ops.quantized_matmul import quantized_matmul_reference
    from mpit_tpu_torch.serve import Engine, Server, quantize_gpt2_params
    from mpit_tpu_torch.serve.__main__ import ServeConfig, synthetic_requests

    cfg = from_argv(ServeConfig, SERVE_ARGS)
    judge = GPT2(
        dataclasses.replace(mcfg, quant_matmul_fn=quantized_matmul_reference),
        device="cuda", quantized=True,
    )
    judge.load_state_dict(quantize_gpt2_params(state))
    results = {}
    for kv_dtype in (None, "int8"):
        runs = {}
        for mode in ("kernel", "reference"):
            engine = Engine(
                mcfg, state, slots=cfg.slots, max_len=cfg.max_len,
                prefill_len=cfg.prefill_len, seed=cfg.seed, device="cuda",
                decode_attention=mode, weights_dtype="int8", kv_dtype=kv_dtype,
            )
            server = Server(engine)
            for req in synthetic_requests(cfg, mcfg.vocab_size):
                server.submit(req)
            runs[mode] = {c.rid: c for c in server.run()}
            del engine, server
            torch.cuda.empty_cache()
        ker, ref = runs["kernel"], runs["reference"]
        tag = "int8_weights" + ("_int8_kv" if kv_dtype else "_f32_kv")
        if len(ker) != 16 or len(ref) != 16:
            fail(f"{tag}: {len(ker)} / {len(ref)} of 16 completed")
        diff = [r for r in ref if ker[r].tokens != ref[r].tokens]
        if kv_dtype is None:
            if diff:
                r = diff[0]
                info = report_divergence(
                    torch, judge, ref[r].prompt, ker[r].tokens, ref[r].tokens
                )
                fail(f"{tag}: f32 greedy tokens differ, kernel vs reference, for "
                     f"{diff}; first: {r} {info}")
            results[tag] = "identical"
            continue
        ties = {
            r: int8_divergence(torch, judge, ref[r].prompt, ker[r].tokens, ref[r].tokens)
            for r in diff
        }
        wide = {r: d for r, d in ties.items() if not abs(d["gap"]) <= INT8_TIE}
        if wide:
            fail(f"{tag}: kernel vs reference part beyond a near-tie "
                 f"(|gap| > {INT8_TIE}): {wide}")
        results[tag] = {"identical_requests": 16 - len(diff), "near_ties": ties}
    print(json.dumps({"parity_int8_weights": results}), flush=True)


def visible_pairs(t: int, q_off: int, k_off: int) -> int:
    """(query, key) pairs of one head that the causal mask lets through."""
    import numpy as np

    pos = np.arange(t)
    return int(((q_off + pos)[:, None] >= (k_off + pos)[None, :]).sum())


def flash_bound(kind: str, b, t, h, d, pairs, dtype) -> tuple[float, str]:
    """The least time for one flash step: its [B, T, H, D] tensors (fwd:
    q, k, v, o; dq: q, k, v, dO, dq; dkv: q, k, v, dO, dk, dv) and [B, H,
    T] f32 rows (fwd: lse; backward: lse, delta) once each over the HBM
    rate, against 4 (fwd), 6 (dq) or 8 (dkv) operations per visible pair
    and head dimension over the peak rate of the inputs' type."""
    n_big, n_rows, n_ops = {"fwd": (4, 1, 4), "dq": (5, 2, 6), "dkv": (6, 2, 8)}[kind]
    item = 2 if dtype == "bfloat16" else 4
    nbytes = n_big * b * t * h * d * item + n_rows * b * h * t * 4
    nops = n_ops * d * pairs * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flash_kernel_phase(torch, flush):
    """Phase 3d: the flash forward, dq and dk/dv kernels against their
    plain versions."""
    import importlib

    import torch.nn.functional as F

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")

    cases = []
    # (dtype, T, q_offset, k_offset, lse cotangent, q/k/v as views of one fused qkv)
    runs = [(dt, t, 0, 0, False, False) for dt in ("bfloat16", "float32") for t in FLASH_T]
    runs += [("bfloat16", 512, 256, 0, False, False), ("bfloat16", 512, 0, 512, False, False),
             ("bfloat16", 512, 0, 0, True, False), ("bfloat16", 512, 0, 0, False, True)]
    for name, t, q_off, k_off, with_g_lse, fused in runs:
        dtype = getattr(torch, name)
        gen = torch.Generator(device="cuda").manual_seed(
            t + q_off + k_off + with_g_lse + 2 * fused
        )
        q, k, v, do = (
            torch.randn((FLASH_B, t, H, DH), generator=gen, device="cuda").to(dtype)
            for _ in range(4)
        )
        if fused:  # the model's layout: rows of the qkv projection, 3 H D apart
            q, k, v = torch.cat((q, k, v), dim=2).split(H, dim=2)
        g_lse = (
            torch.randn((FLASH_B, H, t), generator=gen, device="cuda") if with_g_lse else None
        )
        geo = dict(q_offset=q_off, k_offset=k_off, causal=True)
        before = dict(fa.path_launches)
        o, lse = fa.flash_fwd(q, k, v, q_off, k_off, True)
        delta = fa._delta(o, do, g_lse)
        dq = fa.flash_dq(q, k, v, do, lse, delta, q_off, k_off, True)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, q_off, k_off, True)
        torch.cuda.synchronize()
        # The body of each launch, as the C library named it.
        ran = {n: c - before[n] for n, c in fa.path_launches.items() if c != before[n]}
        body = {n.split("/")[0]: n.split("/")[1] for n in ran}
        want = "mma" if name == "bfloat16" else "fma"
        if ran != {f"{kind}/{want}": 1 for kind in ("fwd", "dq", "dkv")}:
            fail(f"flash {name} T={t}: launches by body {ran}, expected one of each on {want}")
        p_o, p_lse = fa.flash_fwd_plain(q, k, v, **geo)
        p_delta = fa._delta(p_o, do, g_lse)
        plain = {"o": p_o, "lse": p_lse,
                 "dq": fa.flash_dq_plain(q, k, v, do, p_lse, p_delta, **geo)}
        plain["dk"], plain["dv"] = fa.flash_dkv_plain(q, k, v, do, p_lse, p_delta, **geo)
        got = {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
        label = (f"flash {name} T={t} q_off={q_off} k_off={k_off} g_lse={with_g_lse} "
                 f"fused={fused}")
        errs, scale = {}, {}
        for key, ref in plain.items():
            ref = ref.float()
            err = (got[key].float() - ref).abs().max().item()
            tol = LSE_TOL if key == "lse" else TOL[name]
            if not math.isfinite(err) or err > tol:
                fail(f"kernel vs plain {label}: {key} {err} > {tol}")
            errs[key] = err
            kept = ref[ref > -1e29]  # past the -1e30 lse of rows that see no key
            scale[key] = kept.abs().max().item() if kept.numel() else 0.0
        if k_off >= q_off + t and not (bool((o == 0).all()) and bool((lse == -1e30).all())):
            fail(f"{label}: a future key block must give o = 0 and lse = -1e30 exactly")
        if name == "float32" and t == 512 and not q_off and not k_off:
            qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
            ao, _ = fa.reference_attention_with_lse(qa, ka, va)
            ref_grads = torch.autograd.grad(ao, (qa, ka, va), do)
            for key, ref in zip(("dq", "dk", "dv"), ref_grads):
                err = (got[key] - ref).abs().max().item()
                if not err <= TOL[name]:
                    fail(f"{label}: {key} vs autograd of the plain forward {err} > {TOL[name]}")
                errs[key + "_vs_autograd"] = err
        pairs = visible_pairs(t, q_off, k_off)
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        do_h = do.transpose(1, 2)
        lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)  # noqa: E731
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qh, kh, vh), do_h, retain_graph=True
        )
        library = {"fwd": cold_time_ms(lib_fwd, torch, flush),
                   "bwd": cold_time_ms(lib_bwd, torch, flush)}
        steps = {
            "fwd": (lambda: fa.flash_fwd(q, k, v, q_off, k_off, True),
                    lambda: fa.flash_fwd_plain(q, k, v, **geo), library["fwd"]),
            "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, q_off, k_off, True),
                   lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, **geo), library["bwd"]),
            "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, q_off, k_off, True),
                    lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, **geo), library["bwd"]),
        }
        earlier = BEFORE_FLASH_MS[(name, t, q_off, k_off, with_g_lse, fused)]
        for i, (kind, (kernel, plain_fn, lib_ms)) in enumerate(steps.items()):
            bound_ms, bound_by = flash_bound(kind, FLASH_B, t, H, DH, pairs, name)
            cases.append({
                "form": f"flash_{kind}",
                # the tensor-core body, or f32 FMAs on the CUDA cores
                "path": body[kind],
                "before_ms": earlier[i],
                "dtype": name, "B": FLASH_B, "T": t, "H": H,
                "Dh": DH, "q_offset": q_off, "k_offset": k_off, "g_lse": with_g_lse,
                "fused_qkv_views": fused, "visible_pairs_per_head": pairs,
                "max_abs_err": errs, "tol": TOL[name], "lse_tol": LSE_TOL,
                "max_abs_plain": scale,
                "ms": cold_time_ms(kernel, torch, flush),
                "plain_ms": cold_time_ms(plain_fn, torch, flush),
                "library_ms": lib_ms,
                "library": "sdpa causal forward" if kind == "fwd"
                else "sdpa causal backward (dq, dk, dv in one call)",
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
            print(json.dumps({"kernel_case": cases[-1]}), flush=True)
        del lib_out, qh, kh, vh
        torch.cuda.empty_cache()
    return cases


def train_phase(torch, card, flush):
    """Phase 4t: GPT-2 small trains for 30 steps through the flash
    kernels. Returns the launch counts of the run."""
    import importlib

    import numpy as np

    from mpit_tpu_torch.asyncsgd.config import from_argv
    from mpit_tpu_torch.asyncsgd.gpt2 import GPT2TrainConfig, main
    from mpit_tpu_torch.ops.lm_head import lm_head_xent

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    cfg = from_argv(GPT2TrainConfig, TRAIN_ARGS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    fa.path_launches.update(dict.fromkeys(fa.path_launches, 0))
    out = main(TRAIN_ARGS)
    launches = dict(fa.launches)
    bodies = {k: n for k, n in fa.path_launches.items() if n}
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    steps = out["steps"]
    if steps != 30 or len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"train: {steps} steps, losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        fail(f"train: mean of the last five losses {last} >= the first five {first}")
    need = cfg.num_layers * steps
    if any(n < need for n in launches.values()):
        fail(f"train: flash launches {launches} < {need} (layers x steps)")
    if not launches["dq"] == bodies.get("dq/mma") == need:
        fail(f"train: dq launches {launches['dq']}, by body {bodies}: expected {need} on mma")
    # The LM head alone, forward and backward, at the step's 4096 tokens.
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_tok = cfg.batch_size * cfg.seq_len
    h = torch.randn((n_tok, cfg.d_model), generator=gen, device="cuda").bfloat16()
    h.requires_grad_()
    head = (0.02 * torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device="cuda"))
    head.requires_grad_()
    tgt = torch.randint(0, cfg.vocab_size, (n_tok,), generator=gen, device="cuda")

    def head_step():
        loss = lm_head_xent(h, head, tgt, compute_dtype=torch.bfloat16)
        torch.autograd.grad(loss.mean(), (h, head))

    head_ms = cold_time_ms(head_step, torch, flush, iters=5)
    del h, head, tgt
    profile = train_profile(torch)
    step_ms = np.asarray(out["step_ms"][2:])  # past the first steps' set-up
    print(json.dumps({
        "card": card,
        "train": {
            "args": TRAIN_ARGS, "steps": steps, "losses": losses,
            "first5_mean": first, "last5_mean": last,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p95": float(np.percentile(step_ms, 95)),
            "tokens_per_sec": out.get("items_per_sec"),
            "tokens_per_sec_mean": out.get("items_per_sec_mean"),
            "peak_memory_gib": peak / 2**30,
            "launches": launches,
            "launches_by_body": bodies,
            "lm_head_fwd_bwd_ms": head_ms,
            "profiled_steps": profile,
        },
    }), flush=True)
    return launches


def train_profile(torch, steps: int = 3) -> dict:
    """The phase-4t step under ``torch.profiler`` for ``steps`` steps
    (after three warm-up steps): device busy time by kernel family and
    the device's idle share of the window's wall time. Reports, gates
    nothing; "not measured" when the profiler records no device
    activity."""
    import importlib

    from mpit_tpu_torch.asyncsgd.config import from_argv
    from mpit_tpu_torch.asyncsgd.gpt2 import GPT2TrainConfig
    from mpit_tpu_torch.data import SyntheticLM
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.train import make_train_step

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    cfg = from_argv(GPT2TrainConfig, TRAIN_ARGS)
    model = GPT2(cfg.model_config(), device="cuda",
                 generator=torch.Generator().manual_seed(cfg.seed))
    init_fn, step_fn = make_train_step(
        lambda p, b: (GPT2.fused_loss_fn(model, b["tokens"]), {}), goo_adam(cfg.lr)
    )
    state = init_fn(dict(model.named_parameters()))
    batches = SyntheticLM(vocab_size=cfg.vocab_size, seed=cfg.seed).batches(
        cfg.batch_size, cfg.seq_len
    )
    tokens = [torch.from_numpy(next(batches)["tokens"]).long().cuda() for _ in range(steps + 3)]
    for t in tokens[:3]:
        state, _ = step_fn(state, {"tokens": t})
    torch.cuda.synchronize()
    counts = (dict(fa.launches), dict(fa.path_launches))
    holder = {"state": state}

    def one_step(t):
        holder["state"], _ = step_fn(holder["state"], {"tokens": t})

    out = profile_window(torch, one_step, tokens[3:])
    fa.launches.update(counts[0])  # profiled steps are not the main path's run
    fa.path_launches.update(counts[1])
    return out


# Kernel families of the profiles, by substrings of the device kernel's
# name. cuBLAS names its Hopper GEMMs nvjet_* (CUDA 12.8) or *gemm*; the
# goo rules run as foreach (multi_tensor_apply) kernels; copies are the
# gradients' ravel into the flat buffer (_foreach_copy_) and the dtype
# casts (copy kernels).
FAMILIES = {
    "quantized_matmul": ("qmm_mma_kernel", "qmm_fma_kernel"),
    "decode_attention": ("decode_kernel",),
    "flash_attention": ("fwd_kernel", "dq_kernel", "dkv_kernel"),
    # rs_q8_kernel and ag_q8_kernel: the q8 kinds' hop forms in trees
    # before the q8 fold and the q8 copy, for a `dp_profile` run of such a
    # tree.
    "ring_collectives": ("rs_fold_kernel", "rs_q8_fold_kernel", "rs_q8_kernel",
                         "ag_copy_kernel", "ag_q8_copy_kernel", "ag_q8_kernel"),
    "gemm": ("nvjet", "gemm", "xmma", "cutlass"),
    "copies": ("copy",),
    "optimizer_foreach": ("foreach", "multi_tensor"),
}


def profile_window(torch, one_step, batches, families=None) -> dict:
    """``one_step(batch)`` over ``batches`` under ``torch.profiler``:
    device busy time by kernel family (``families``, default
    :data:`FAMILIES`) and the device's idle share of the window's wall
    time. Reports, gates nothing; "not measured" when the profiler
    records no device activity."""
    families = FAMILIES if families is None else families
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            one_step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = len(batches)
    busy, kernels, ring = {}, {}, {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        name = e.key.lower()
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)),
                   "other")
        busy[fam] = busy.get(fam, 0.0) + e.self_device_time_total / 1e3
        kernels[e.key[:80]] = kernels.get(e.key[:80], 0.0) + e.self_device_time_total / 1e3
        if fam == "ring_collectives":
            kind = next(k for k in families[fam] if k in name)
            ring[kind] = ring.get(kind, 0.0) + e.self_device_time_total / 1e3
    if not busy:
        return {"profile": "not measured (no device activity recorded)",
                "wall_ms_per_step": wall_ms / steps}
    total = sum(busy.values())
    return {
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": total / steps,
        "device_idle_share": max(0.0, 1.0 - total / wall_ms),
        "busy_ms_per_step_by_family": {f: v / steps for f, v in sorted(busy.items())},
        "ring_collectives_ms_per_step_by_kernel": {k: v / steps for k, v in sorted(ring.items())},
        "top_kernels_ms_per_step": {
            k: v / steps for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        },
    }


def ring_bound(kind: str, p: int, rows: int, in_item: int, out_item: int, q8: bool):
    """The least time for one ring collective over ``p`` ranks of
    ``rows x 128`` chunks: a reduce-scatter reads every rank's p chunks
    and writes one chunk a rank, an all-gather reads one chunk a rank and
    writes p; over the HBM rate, against its f32 operations (sum: one add
    an element and hop; q8 reduce-scatter four: amax, divide, multiply,
    add; q8 all-gather three a source element: amax, divide, multiply)
    over the f32 non-tensor peak. Returns ``(bound_ms, by)``."""
    c = rows * 128
    if kind == "rs":
        nbytes = p * p * c * in_item + p * c * out_item
        nops = (4 if q8 else 1) * (p - 1) * p * c
    else:
        nbytes = p * c * in_item + p * p * c * out_item
        nops = 3 * p * c if q8 else 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S["float32"] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def ring_schedule_bytes(schedule: str, p: int, rows: int, in_item: int, out_item: int) -> int:
    """Bytes the schedule itself moves on one card. The fold and the
    resident q8 fold read every rank's p chunks once and write one chunk
    a rank, the copy and the resident q8 copy read one chunk a rank once
    and write it p times: the bound's bytes. The streaming q8 fold, per
    rank: hop 0 reads the first copy (its amax), hop 1 reads it again
    with the second and writes the f32 partial, each later hop reads the
    partial and a copy and rewrites the partial. The streaming q8 copy
    reads each chunk twice (its amax, then its stores), counted from HBM
    though the second read may find it in L2."""
    c = rows * 128
    if schedule in ("fold", "q8fold_resident"):
        return p * p * c * in_item + p * c * out_item
    if schedule in ("copy", "q8copy_resident"):
        return p * c * in_item + p * p * c * out_item
    if schedule == "q8copy_stream":
        return 2 * p * c * in_item + p * p * c * out_item
    if schedule == "q8fold_stream":
        return p * (c * in_item * (p + 1) + c * out_item * (2 * p - 3))
    raise ValueError(f"no byte count for the schedule {schedule!r}")


def bits(torch, t):
    """``t``'s elements as integers of their width: equal bits, signed
    zeros too, where ``torch.equal`` of the floats takes -0 for +0."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def ring_case(torch, flush, kind: str, xs, quantized: bool, label: str, **extra):
    """Phase 3e, one case: the kernel (``reduce_scatter_chunks`` /
    ``all_gather_chunks``) against its plain version, bit for bit, with
    the kernel, plain and library times, the bound and the schedule's
    bytes, and apart from those the device times without the host's lead
    and the wrapper's host time. A q8 case names the form the C library's
    plan gives its kernel and fails unless that form's launch count
    moved."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    p, rows = xs.shape[0], xs.shape[-2]
    if kind == "rs":
        run = lambda: rc.reduce_scatter_chunks(xs, quantized=quantized)  # noqa: E731
        plain = lambda: rc.reduce_scatter_plain(xs, quantized=quantized)  # noqa: E731
        lib = lambda: xs.reshape(p, p, -1).sum(0)  # noqa: E731
        out_item = 4 if quantized else xs.element_size()
    else:
        run = lambda: rc.all_gather_chunks(xs, quantized=quantized)  # noqa: E731
        plain = lambda: rc.all_gather_plain(xs, quantized=quantized)  # noqa: E731
        lib = lambda: xs.reshape(1, -1).expand(p, -1).clone()  # noqa: E731
        out_item = xs.element_size()
    name = f"ring_{kind}" + ("_q8" if quantized else "")
    if quantized:
        schedule = rc.q8_plan(name, p, rows, xs.dtype, xs.device)["form"]
    else:
        schedule = {"rs": "fold", "ag": "copy"}[kind]
    before = dict(rc.path_launches)
    got = run()
    torch.cuda.synchronize()
    moved = {k: n - before[k] for k, n in rc.path_launches.items() if n != before[k]}
    if moved != ({schedule: 1} if quantized else {}):
        fail(f"ring {label}: q8 launches by form {moved}, the plan names {schedule}")
    want = plain()
    if not torch.equal(bits(torch, got), bits(torch, want)):
        err = (got.float() - want.float()).abs().max().item()
        fail(f"ring {label}: kernel != plain (max |error| {err}); {rc.device_error()}")
    if kind == "ag" and not all(torch.equal(bits(torch, got[r]), bits(torch, got[0]))
                                for r in range(1, p)):
        fail(f"ring {label}: the gathered replicas differ")
    in_item = xs.element_size()
    bound_ms, bound_by = ring_bound(kind, p, rows, in_item, out_item, quantized)
    case = {
        "form": name, "label": label, "schedule": schedule,
        "dtype": str(xs.dtype).removeprefix("torch."), "p": p, "rows": rows, **extra,
        "max_abs_err": 0.0, "bit_equal": True,
        "ms": cold_time_ms(run, torch, flush),
        "plain_ms": cold_time_ms(plain, torch, flush),
        "library_ms": cold_time_ms(lib, torch, flush),
        # The same two calls with their host time before the launch left
        # out, and the wrapper's host time a call.
        "device_ms": cold_time_ms(run, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
        "library_device_ms": cold_time_ms(lib, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
        "host_ms": host_time_ms(run, torch),
        "library": "xs.view(p, p, c).sum(0)" if kind == "rs"
        else "expand-and-copy of the concatenated shards",
        "bound_ms": bound_ms, "bound_by": bound_by,
        "ring_schedule_bytes": ring_schedule_bytes(schedule, p, rows, in_item, out_item),
    }
    print(json.dumps({"kernel_case": case}), flush=True)
    return case


def cuda_randn(torch, shape, seed: int, dtype=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype or torch.float32)


def plan_ring_cases(torch, flush, plans: dict) -> list:
    """Phase 3e at the convnets' and ResNet-50's bucket plans over
    DP_RANKS ranks (``plans``, :func:`convnet_bucket_plans`), f32, sum
    and q8: each net's first full bucket and, where it has more than
    one, its ragged tail, read in place from a wider buffer as the bucket
    loop reads them."""
    cases = []
    for q8 in (False, True):
        for net, plan in plans.items():
            head = plan["first_bucket_rows"]
            picks = {"bucket": (0, head)}
            if plan["buckets"] > 1:
                picks["tail bucket"] = (head, head + plan["tail_rows"])
            for what, (r0, r1) in picks.items():
                wide = cuda_randn(torch, (DP_RANKS, DP_RANKS, r1, 128), 11)
                cases.append(ring_case(torch, flush, "rs", wide[:, :, r0:r1], q8,
                                       f"rs {net} {what} q8={q8}", strided=r0 > 0,
                                       workload=net))
                shards = cuda_randn(torch, (DP_RANKS, r1, 128), 12)
                cases.append(ring_case(torch, flush, "ag", shards[:, r0:r1], q8,
                                       f"ag {net} {what} q8={q8}", strided=r0 > 0,
                                       workload=net))
                del wide, shards
        torch.cuda.empty_cache()
    return cases


def ring_kernel_phase(torch, flush, tail_rows: int, conv_plans: dict):
    """Phase 3e: the four ring kernels against their plain versions; at
    GPT-2 small's bucket plan and at the convnets' and ResNet-50's
    (``conv_plans``, :func:`plan_ring_cases`)."""
    from mpit_tpu_torch.ops import ring_collectives as rc

    def randn(shape, seed, dtype=torch.float32):
        return cuda_randn(torch, shape, seed, dtype)

    cases = []
    forms = [(dtype, q8) for q8 in (False, True) for dtype in (torch.float32, torch.bfloat16)]
    for p in RING_P:
        for dtype, q8 in forms:
            name = str(dtype).removeprefix("torch.")
            tag = f"p={p} {name}{' q8' if q8 else ''} rows={RING_ROWS}"
            cases.append(ring_case(torch, flush, "rs", randn((p, p, RING_ROWS, 128), p, dtype),
                                   q8, f"rs {tag}"))
            cases.append(ring_case(torch, flush, "ag", randn((p, RING_ROWS, 128), p + 1, dtype),
                                   q8, f"ag {tag}"))
        torch.cuda.empty_cache()
    # GPT-2 small's ragged tail bucket, read in place from a wider buffer.
    for q8 in (False, True):
        wide = randn((DP_RANKS, DP_RANKS, RING_ROWS + tail_rows, 128), 5)
        cases.append(ring_case(torch, flush, "rs", wide[:, :, RING_ROWS:], q8,
                               f"rs tail bucket q8={q8}", strided=True))
        shards = randn((DP_RANKS, RING_ROWS + tail_rows, 128), 6)
        cases.append(ring_case(torch, flush, "ag", shards[:, RING_ROWS:], q8,
                               f"ag tail bucket q8={q8}", strided=True))
    cases += plan_ring_cases(torch, flush, conv_plans)
    # An all-zero chunk (scale 1.0) in the q8 forms.
    xs = randn((DP_RANKS, DP_RANKS, 256, 128), 7)
    xs[:, 2] = 0
    cases.append(ring_case(torch, flush, "rs", xs, True, "rs q8 zero chunk", zero_chunk=2))
    shards = randn((DP_RANKS, 256, 128), 8)
    shards[1] = 0
    cases.append(ring_case(torch, flush, "ag", shards, True, "ag q8 zero chunk", zero_chunk=1))
    # Payloads the planner must pad (p 4, not a multiple of 4 x 128).
    for q8 in (False, True):
        n = 1_000_003
        x = randn((DP_RANKS, n), 9)
        wire = torch.int8 if q8 else torch.float32
        plan = rc.plan_ring(n, DP_RANKS, wire)
        got = rc.ring_reduce_scatter(x, op="qsum" if q8 else "sum")
        x4 = plan.to_wire(x).reshape(DP_RANKS, DP_RANKS, plan.padded_rows, 128)
        want = plan.shard_from_wire(rc.reduce_scatter_plain(x4, quantized=q8))
        splan = rc.plan_shards(n // 4, DP_RANKS, wire)
        sh = x[:, : n // 4]
        got_ag = rc.ring_all_gather(sh, quantized=q8)
        want_ag = splan.gathered_from_wire(
            rc.all_gather_plain(splan.shard_to_wire(sh), quantized=q8).reshape(
                DP_RANKS, DP_RANKS * splan.padded_rows, 128), n // 4,
        )
        if not (torch.equal(bits(torch, got), bits(torch, want))
                and torch.equal(bits(torch, got_ag), bits(torch, want_ag))):
            fail(f"ring planner-padded payload q8={q8}: kernel != plain")
        cases.append({"form": "ring_public_padded", "q8": q8, "payload": n, "p": DP_RANKS,
                      "chunk_rows": plan.chunk_rows, "padded_rows": plan.padded_rows,
                      "bit_equal": True})
        print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    err = rc.device_error()
    if err:
        fail(err)
    torch.cuda.empty_cache()
    return cases


def dp_bucket_plan(torch):
    """GPT-2 small's flat length over DP_RANKS ranks and its buckets."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd.config import from_argv
    from mpit_tpu_torch.asyncsgd.gpt2 import GPT2TrainConfig
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len
    from mpit_tpu_torch.train.grad_sync import GradSync

    cfg = from_argv(GPT2TrainConfig, DP_ARGS)
    layout = FlatLayout(dict(GPT2(cfg.model_config(), device="meta").named_parameters()))
    rows = padded_len(layout.total, DP_RANKS) // (DP_RANKS * 128)
    world = comm.init({"data": DP_RANKS}, devices=["cuda"])
    buckets = GradSync(world, "ring", bucket_mb=cfg.grad_bucket_mb).bucket_rows(rows)
    return {"flat_len": layout.total, "shard_rows": rows, "buckets": len(buckets),
            "tail_rows": buckets[-1][1] - buckets[-1][0]}


def dp_train_phase(torch, card, mode: str, plan: dict):
    """Phase 4d: GPT-2 small over DP_RANKS ranks on the card, ZeRO-1, the
    gradient sync ``mode``, 30 steps. Returns the run's ring launch
    counts, its q8 launches by form and its losses."""
    import importlib

    import numpy as np

    from mpit_tpu_torch.asyncsgd.gpt2 import main
    from mpit_tpu_torch.ops import ring_collectives as rc

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    args = DP_ARGS + ["--grad-sync", mode]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    rc.launches.update(dict.fromkeys(rc.launches, 0))
    rc.path_launches.update(dict.fromkeys(rc.path_launches, 0))
    out = main(args)
    flash, ring, forms = dict(fa.launches), dict(rc.launches), dict(rc.path_launches)
    peak = torch.cuda.max_memory_allocated()
    losses, steps = out["losses"], out["steps"]
    if steps != 30 or len(losses) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"dp {mode}: {steps} steps, losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        fail(f"dp {mode}: mean of the last five losses {last} >= the first five {first}")
    need_flash = 12 * DP_RANKS * steps
    if any(n != need_flash for n in flash.values()):
        fail(f"dp {mode}: flash launches {flash}, expected {need_flash} each")
    need_ring = plan["buckets"] * steps
    q = "_q8" if mode == "ring_q8" else ""
    want = {k: need_ring if k in (f"ring_rs{q}", f"ring_ag{q}") else 0 for k in ring}
    if ring != want:
        fail(f"dp {mode}: ring launches {ring}, expected {want}")
    # ring_q8: every reduce-scatter and all-gather on the form the plan
    # names for its bucket's rows (resident at p 4, 8192 rows and the
    # tail); the all-gather moves the f32 parameter updates.
    want_forms = dict.fromkeys(forms, 0)
    if q:
        for rows in [RING_ROWS] * (plan["buckets"] - 1) + [plan["tail_rows"]]:
            for kind in ("ring_rs_q8", "ring_ag_q8"):
                form = rc.q8_plan(kind, DP_RANKS, rows, torch.float32,
                                  torch.device("cuda", 0))["form"]
                want_forms[form] += steps
    if forms != want_forms:
        fail(f"dp {mode}: q8 launches by form {forms}, expected {want_forms}")
    if not out["replicas_identical"]:
        fail(f"dp {mode}: the {DP_RANKS} parameter replicas differ after the run")
    if out["grad_sync"] != mode:
        fail(f"dp {mode}: the step ran {out['grad_sync']}")
    step_ms = np.asarray(out["step_ms"][2:])
    print(json.dumps({
        "card": card,
        "train_dp": {
            "args": args, "ranks": out["ranks"], "grad_sync": out["grad_sync"],
            "steps": steps, "losses": losses, "first5_mean": first, "last5_mean": last,
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p95": float(np.percentile(step_ms, 95)),
            "tokens_per_sec": out.get("items_per_sec"),
            "tokens_per_sec_mean": out.get("items_per_sec_mean"),
            "peak_memory_gib": peak / 2**30,
            "replicas_identical": True,
            "bucket_plan": plan, "ring_launches": ring, "q8_launches_by_form": forms,
            "flash_launches": flash,
        },
    }), flush=True)
    return ring, forms, losses


def dp_models(torch, cfg, init, attention):
    from mpit_tpu_torch.models import GPT2

    models = []
    for _ in range(DP_RANKS):
        m = GPT2(dataclasses.replace(cfg, attention_fn=attention), device="cuda")
        m.load_state_dict(init)
        models.append(m)
    return models


def dp_step(torch, models, mode: str, cfg_lr: float):
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.train import make_train_step

    world = comm.init({"data": DP_RANKS}, devices=["cuda"])
    init_fn, step_fn = make_train_step(
        [lambda p, b, m=m: (GPT2.fused_loss_fn(m, b["tokens"].long()), {}) for m in models],
        goo_adam(cfg_lr), world, grad_sync=mode,
    )
    return world, init_fn([dict(m.named_parameters()) for m in models]), step_fn


def dp_parity_phase(torch, q8_losses):
    """Phase 5d: f32 ring vs psum over 3 steps from one set of weights;
    bf16 ring_q8 (phase 4d's curve) vs psum over 30 steps."""
    import importlib

    from mpit_tpu_torch.asyncsgd.gpt2 import main
    from mpit_tpu_torch.data import SyntheticLM, shard_batch
    from mpit_tpu_torch.models import GPT2Config

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    cfg = GPT2Config.small(dtype=torch.float32, max_seq_len=512)
    init = seeded_gpt2_state(torch, cfg, 0)
    losses = {}
    for mode in ("psum", "ring"):
        models = dp_models(torch, cfg, init, fa.flash_attention)
        world, state, step_fn = dp_step(torch, models, mode, 3e-4)
        batches = SyntheticLM(vocab_size=cfg.vocab_size, seed=0).batches(8, 512)
        losses[mode] = []
        for _ in range(3):
            state, metrics = step_fn(state, shard_batch(world, next(batches)))
            losses[mode].append(metrics["loss"].item())
        if not state.replicas_equal():
            fail(f"dp parity f32 {mode}: replicas differ")
        del models, state, step_fn
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["ring"], losses["psum"])]
    if not max(rel) <= DP_PARITY_TOL:
        fail(f"dp parity f32: ring {losses['ring']} vs psum {losses['psum']}: {rel}")
    out = main(DP_ARGS + ["--grad-sync", "psum"])
    psum = out["losses"]
    if len(psum) != 30 or not out["replicas_identical"]:
        fail(f"dp parity bf16: psum run {len(psum)} losses, replicas {out['replicas_identical']}")
    gaps = [abs(a - b) for a, b in zip(psum, q8_losses)]
    wide = [i for i, (a, g) in enumerate(zip(psum, gaps)) if not g <= 0.02 + 0.02 * abs(a)]
    if wide:
        fail(f"dp parity bf16: ring_q8 leaves 0.02 + 0.02|loss| of psum at steps {wide}: "
             f"{psum} vs {q8_losses}")
    if psum == q8_losses:
        fail("dp parity bf16: the ring_q8 curve equals psum's: the int8 wire did not run")
    print(json.dumps({"dp_parity": {
        "f32_3_steps": {"losses": losses, "max_rel_diff": max(rel),
                        "bit_equal": losses["ring"] == losses["psum"]},
        "bf16_30_steps": {"psum": psum, "ring_q8": q8_losses, "max_abs_gap": max(gaps)},
    }}), flush=True)


def dp_profile(torch, mode: str, steps: int = 3) -> dict:
    """Three DP steps (DP_RANKS ranks, the gradient sync ``mode``, the
    phase-4d model) under ``torch.profiler`` after three warm-up steps."""
    import importlib

    from mpit_tpu_torch.asyncsgd.config import from_argv
    from mpit_tpu_torch.asyncsgd.gpt2 import GPT2TrainConfig
    from mpit_tpu_torch.data import SyntheticLM, shard_batch
    from mpit_tpu_torch.ops import ring_collectives as rc

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    cfg = from_argv(GPT2TrainConfig, DP_ARGS)
    mcfg = cfg.model_config()
    init = seeded_gpt2_state(torch, mcfg, cfg.seed)
    models = dp_models(torch, mcfg, init, mcfg.attention_fn)
    world, state, step_fn = dp_step(torch, models, mode, cfg.lr)
    batches = SyntheticLM(vocab_size=cfg.vocab_size, seed=cfg.seed).batches(
        cfg.batch_size, cfg.seq_len
    )
    tokens = [shard_batch(world, next(batches)) for _ in range(steps + 3)]
    counts = (dict(fa.launches), dict(rc.launches))
    holder = {"state": state}

    def one_step(b):
        holder["state"], _ = step_fn(holder["state"], b)

    for b in tokens[:3]:
        one_step(b)
    torch.cuda.synchronize()
    out = {"grad_sync": mode, **profile_window(torch, one_step, tokens[3:])}
    fa.launches.update(counts[0])  # profiled steps are not the main path's run
    rc.launches.update(counts[1])
    del models, holder, state
    torch.cuda.empty_cache()
    return out


def train_parity_phase(torch):
    """Phase 5t: f32, three goo_adam steps, flash-kernel step vs plain
    step from the same weights."""
    import dataclasses
    import importlib

    from mpit_tpu_torch.data import SyntheticLM
    from mpit_tpu_torch.models import GPT2, GPT2Config, default_attention
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.train import make_train_step

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    cfg = GPT2Config.small(dtype=torch.float32, max_seq_len=512)
    init = seeded_gpt2_state(torch, cfg, 0)
    losses = {}
    for label, attn in (("flash", fa.flash_attention), ("plain", default_attention)):
        model = GPT2(dataclasses.replace(cfg, attention_fn=attn), device="cuda")
        model.load_state_dict(init)
        init_fn, step_fn = make_train_step(
            lambda p, b: (GPT2.fused_loss_fn(model, b["tokens"]), {}), goo_adam(3e-4)
        )
        state = init_fn(dict(model.named_parameters()))
        batches = SyntheticLM(vocab_size=cfg.vocab_size, seed=0).batches(8, 512)
        before = dict(fa.launches)
        losses[label] = []
        for _ in range(3):
            tokens = torch.from_numpy(next(batches)["tokens"]).long().cuda()
            state, metrics = step_fn(state, {"tokens": tokens})
            losses[label].append(metrics["loss"].item())
        ran = {n: fa.launches[n] - before[n] for n in before}
        want = cfg.num_layers * 3 if label == "flash" else 0
        if any(n != want for n in ran.values()):
            fail(f"train parity {label}: flash launches {ran}, expected {want} each")
        del model, state
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["flash"], losses["plain"])]
    if not max(rel) <= TRAIN_PARITY_TOL:
        fail(f"train parity f32: losses {losses} differ by {rel} > {TRAIN_PARITY_TOL}")
    print(json.dumps({"train_parity_f32": {"losses": losses, "max_rel_diff": max(rel)}}),
          flush=True)


# Phase 3f's sizes at which each body of the copy kernel is timed apart.
SHIP_BODY_SIZES = ("payload bf16", "payload int8", "32 MiB", "256 MiB", "alexnet flat f32")


def ship_case(torch, flush, label: str, src, dst):
    """Phase 3f, one case: the copy kernel against its plain version, bit
    for bit (byte views), on the body the C library's plan names (each
    body must copy bit for bit too), with the kernel, plain and library
    times and the bound; then, as in 3e, the kernel's
    and the library's device times without the host's lead and the
    wrapper's host time. At :data:`SHIP_BODY_SIZES` each body is also
    timed on its own (``bodies``)."""
    from mpit_tpu_torch.ops import kv_ship

    plan = kv_ship.kernel_plan(src, dst)
    before = dict(kv_ship.path_launches)
    kv_ship.ship_bytes(src, dst)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kv_ship.path_launches.items() if n != before[k]}
    if ran != {plan["body"]: 1}:
        fail(f"kv_ship {label}: launches by body {ran}, the plan names {plan['body']}")
    want = torch.zeros_like(dst)
    kv_ship.ship_bytes_plain(src, want)
    got_b, want_b = kv_ship.byte_view(dst), kv_ship.byte_view(want)
    if not torch.equal(got_b, want_b) or not torch.equal(got_b, kv_ship.byte_view(src)):
        err = (got_b.int() - want_b.int()).abs().max().item()
        fail(f"kv_ship {label}: kernel != plain (max |byte error| {err})")
    for body in kv_ship.BODIES:
        dst.zero_()
        kv_ship.ship_bytes(src, dst, body=body)
        torch.cuda.synchronize()
        if not torch.equal(kv_ship.byte_view(dst), want_b):
            fail(f"kv_ship {label}: the {body} body != plain")
    n = kv_ship.tensor_nbytes(src)
    run = lambda: kv_ship.ship_bytes(src, dst)  # noqa: E731
    lib = lambda: dst.copy_(src)  # noqa: E731
    case = {
        "form": "kv_ship", "label": label, "dtype": str(src.dtype).removeprefix("torch."),
        "shape": list(src.shape), "bytes": n,
        "src_offset": src.data_ptr() % 16, "dst_offset": dst.data_ptr() % 16,
        "body": plan["body"], "word_bytes": plan["word"], "blocks": plan["blocks"],
        "max_abs_err": 0.0, "bit_equal": True, "bit_equal_bodies": list(kv_ship.BODIES),
        "ms": cold_time_ms(run, torch, flush),
        "plain_ms": cold_time_ms(lambda: kv_ship.ship_bytes_plain(src, dst), torch, flush),
        "library_ms": cold_time_ms(lib, torch, flush),
        "library": "dst.copy_(src) (cudaMemcpyAsync device to device)",
        "device_ms": cold_time_ms(run, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
        "library_device_ms": cold_time_ms(lib, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
        "host_ms": host_time_ms(run, torch),
        # Read n bytes once, write n bytes once; no arithmetic.
        "bound_ms": 2 * n / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    if label in SHIP_BODY_SIZES:
        case["bodies"] = {}
        for body in kv_ship.BODIES:
            one = lambda b=body: kv_ship.ship_bytes(src, dst, body=b)  # noqa: E731
            case["bodies"][body] = {
                "ms": cold_time_ms(one, torch, flush),
                "device_ms": cold_time_ms(one, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
                "blocks": kv_ship.kernel_plan(src, dst, body)["blocks"],
            }
    print(json.dumps({"kernel_case": case}), flush=True)
    return case


def ship_kernel_phase(torch, flush):
    """Phase 3f: the KV shipment's copy kernel against its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=dtype)
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def bytes_at(n, offset):
        """``n`` random bytes starting ``offset`` bytes into a fresh buffer."""
        return torch.randint(0, 256, (n + 16,), generator=gen, device="cuda",
                             dtype=torch.uint8)[offset:offset + n]

    leaf = (L_SMALL, SHIP_ROWS, H, DH)
    cases = []
    for label, dtype, shape in (
        ("leaf k/v bf16", torch.bfloat16, leaf),
        ("leaf k.q/v.q int8", torch.int8, leaf),
        ("leaf k.scale/v.scale f32", torch.float32, leaf[:-1] + (1,)),
    ):
        src = rnd(shape, dtype)
        cases.append(ship_case(torch, flush, label, src, torch.empty_like(src)))
    for label, n in SHIP_PAYLOADS.items():
        src = bytes_at(n, 0)
        cases.append(ship_case(torch, flush, label, src, torch.empty_like(src)))
    for n in (1, 15, 17, 4711):
        cases.append(ship_case(torch, flush, f"ragged {n} B", bytes_at(n, 0), bytes_at(n, 0)))
    n = SHIP_PAYLOADS["payload bf16"]
    for so, do in ((1, 3), (3, 1), (1, 0), (3, 3)):
        cases.append(ship_case(torch, flush, f"bf16 payload, src +{so} B, dst +{do} B",
                               bytes_at(n, so), bytes_at(n, do)))
    for mib in (32, 256):
        src = bytes_at(mib * 2**20, 0)
        cases.append(ship_case(torch, flush, f"{mib} MiB", src, torch.empty_like(src)))
    # The parity protocol's AlexNet message: the flat f32 parameter
    # vector (61,101,056 elements, 244.4 MB).
    src = rnd((ALEXNET_FLAT,), torch.float32)
    cases.append(ship_case(torch, flush, "alexnet flat f32", src, torch.empty_like(src)))
    return cases


def fleet_divergences(torch, model, prompts, got, want, quantized: bool, what: str = "fleet",
                      one_sided: bool = False, tie: float = INT8_TIE):
    """Each request whose fleet tokens part from the single Server's: its
    first diverging token judged by the plain path teacher-forced on the
    Server's tokens (int8 cache when ``quantized``). Fails when a gap
    exceeds ``tie`` (default ``INT8_TIE``); with ``one_sided``, only when
    the plain path ranks the Server's token above ``got``'s by more than
    ``tie`` (a ``got`` token the plain path ranks higher is no fault of
    ``got``'s run)."""
    ties = {}
    for r in want:
        if got.get(r) == want[r]:
            continue
        if len(got.get(r, ())) != len(want[r]):
            fail(f"{what}: request {r} has {len(got.get(r, ()))} tokens, the Server's {len(want[r])}")
        if quantized:
            ties[r] = int8_divergence(torch, model, prompts[r], got[r], want[r])
        else:
            i = next(j for j, (a, b) in enumerate(zip(got[r], want[r])) if a != b)
            with torch.no_grad():
                row = model(torch.tensor([prompts[r] + want[r][:i]], device="cuda"))[0, -1].float()
            ties[r] = {"token_index": i, "got": got[r][i], "want": want[r][i],
                       "gap": (row[want[r][i]] - row[got[r][i]]).item()}
    wide = {r: d for r, d in ties.items()
            if not (d["gap"] if one_sided else abs(d["gap"])) <= tie}
    if wide:
        fail(f"{what}: tokens part from the Server's beyond a near-tie (gap > {tie}): {wide}")
    return ties


def server_tokens(torch, args, cache: dict):
    """The single Server's greedy tokens for the CLI configuration
    ``args`` (phase 4's run, rebuilt in process: greedy decode on the
    same engine is deterministic) and the requests' prompts; each
    configuration runs once a ``cache`` (4f and 4s share the plain runs)."""
    key = tuple(args)
    if key not in cache:
        cache[key] = _server_tokens(torch, args)
    return cache[key]


def _server_tokens(torch, args):
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.serve import Server
    from mpit_tpu_torch.serve.__main__ import ServeConfig, _build_engine, synthetic_requests

    cfg = from_argv(ServeConfig, args)
    engine, mcfg = _build_engine(cfg)
    server = Server(engine)
    reqs = list(synthetic_requests(cfg, mcfg.vocab_size))
    for req in reqs:
        server.submit(req)
    tokens = {str(c.rid): list(c.tokens) for c in server.run()}
    del engine, server
    torch.cuda.empty_cache()
    return tokens, {str(r.rid): list(r.prompt) for r in reqs}


def fleet_phase(torch, card, ship_cases, tokens: dict):
    """Phase 4f: ``python -m mpit_tpu_torch.serve --fleet``'s ``main`` in
    process at phase 4's configuration: dense with one prefill and one
    decode worker, the paged pool with int8 K/V and two decode workers,
    then dense int8 weights with two decode workers (every worker's
    engine launches the matmul from its own thread, so the split
    contraction's shared workspace is used from several threads).
    Returns the copy kernel's launches in each run and the runs'
    records."""
    import dataclasses

    from mpit_tpu_torch.models import GPT2, GPT2Config
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import kv_ship
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.serve import quantize_gpt2_params
    from mpit_tpu_torch.serve.__main__ import main

    state = seeded_gpt2_state(torch, GPT2Config.small(), 0)
    judge = GPT2(GPT2Config.small(), device="cuda")
    judge.load_state_dict(state)
    # The int8-weight model, teacher-forced to judge that run's partings.
    judge_int8w = GPT2(
        dataclasses.replace(GPT2Config.small(), quant_matmul_fn=qm.quantized_matmul_reference),
        device="cuda", quantized=True,
    )
    judge_int8w.load_state_dict(quantize_gpt2_params(state))
    del state
    per_ship = {c["label"]: 2 * c["ms"] for c in ship_cases if c["label"].startswith("payload")}
    launches, records = {}, []
    for name, args, form, spec in (
        ("dense", [], FORMS[0], "prefill=1,decode=1"),
        ("paged_int8_kv", PAGED_ARGS + ["--kv-dtype", "int8"], FORMS[3], "prefill=1,decode=2"),
        ("dense_int8_weights", INT8W_ARGS, FORMS[0], "prefill=1,decode=2"),
    ):
        int8w = "--weights-dtype" in args
        want, prompts = server_tokens(torch, SERVE_ARGS + args, tokens)
        da.launches.update(dict.fromkeys(da.launches, 0))
        da.path_launches.update(dict.fromkeys(da.path_launches, 0))
        qm.launches.update(dict.fromkeys(qm.launches, 0))
        qm.path_launches.update(dict.fromkeys(qm.path_launches, 0))
        kv_ship.launches.update(dict.fromkeys(kv_ship.launches, 0))
        t0 = time.perf_counter()
        out = main(SERVE_ARGS + args + ["--fleet", f"{spec},{FLEET_LIVENESS}"])
        run_s = time.perf_counter() - t0
        counts = dict(da.launches)
        ships = kv_ship.launches["kv_ship"]
        shipments = sum(w.get("processed", 0) for w in out["workers"])
        ticks = sum(w.get("ticks", 0) for w in out["workers"])
        tag = f"fleet {name} ({spec})"
        if out["requests_completed"] != 16 or out["generated_tokens"] != 16 * 32:
            fail(f"{tag}: {out['requests_completed']} of 16 requests, "
                 f"{out['generated_tokens']} tokens")
        if shipments < 16 or ships < 2 * shipments:
            fail(f"{tag}: {ships} kv_ship launches for {shipments} shipments (need 2 each)")
        need = out["model"]["layers"] * (shipments + ticks)
        if counts[form] < need or any(n for f, n in counts.items() if f != form):
            fail(f"{tag}: attention launches {counts}, need {form} >= {need} and no other form")
        matmuls = qm.launches["quantized_matmul"]
        need_mm = 4 * out["model"]["layers"] * (shipments + ticks) if int8w else 0
        if not int8w and matmuls:
            fail(f"{tag}: quantized_matmul launched without --weights-dtype int8")
        if int8w and (matmuls < need_mm or qm.path_launches != {"fma": 0, "mma": matmuls}):
            fail(f"{tag}: matmul launches {matmuls} by body {qm.path_launches}, "
                 f"need >= {need_mm}, all on mma")
        if out["device"] != "cuda":
            fail(f"{tag} ran on {out['device']}")
        ties = fleet_divergences(torch, judge_int8w if int8w else judge, prompts,
                                 out["completed"], want, quantized="--kv-dtype" in args)
        shipped = sum(w.get("ship_bytes", 0) for w in out["workers"])
        payload = "payload int8" if "--kv-dtype" in args else "payload bf16"
        launches[name] = ships
        records.append({
            "card": card, "fleet": name, "spec": spec, "args": args,
            "wall_s": out["wall_s"], "fleet_req_per_s": out["fleet_req_per_s"],
            "main_s": run_s, "requests_completed": out["requests_completed"],
            "generated_tokens": out["generated_tokens"], "shipments": shipments,
            "bytes_shipped": shipped, "kv_ship_launches": ships,
            f"kv_ship_ms_a_shipment_at_the_128_row_{payload.split()[1]}_payload": per_ship[payload],
            "attention_launches": counts[form], "decode_ticks": ticks,
            "matmul_launches": matmuls,
            "attention_launches_by_body": {k: n for k, n in da.path_launches.items() if n},
            "router": {k: out["router"][k] for k in ("evictions", "requeues")},
            "tokens_vs_server": {"identical_requests": 16 - len(ties), "near_ties": ties},
        })
        print(json.dumps(records[-1]), flush=True)
    del judge, judge_int8w
    torch.cuda.empty_cache()
    return launches, records


def fleet_parity_phase(torch):
    """Phase 5f: ``run_fleet`` in f32 at full width (one prefill and two
    decode workers, 4 greedy requests) against the single Server: the
    same tokens; then a decode worker killed at its tick 5 (at least one
    re-queue), the same tokens again. Returns the two runs' results."""
    from mpit_tpu_torch.compat import FaultPlan
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.models import GPT2Config
    from mpit_tpu_torch.serve import Engine, Server, run_fleet
    from mpit_tpu_torch.serve.__main__ import ServeConfig, synthetic_requests

    cfg = from_argv(ServeConfig, SERVE_ARGS + ["--requests", "4"])
    mcfg = GPT2Config.small(dtype=torch.float32)
    state = seeded_gpt2_state(torch, mcfg, cfg.seed)
    geo = dict(slots=cfg.slots, max_len=cfg.max_len, prefill_len=cfg.prefill_len,
               seed=cfg.seed, device="cuda")
    server = Server(Engine(mcfg, state, **geo))
    for req in synthetic_requests(cfg, mcfg.vocab_size):
        server.submit(req)
    want = {str(c.rid): list(c.tokens) for c in server.run()}
    del server
    results = {}
    for name, plan, lease in (("no fault", None, 5.0),
                              ("decode rank 2 killed at tick 5",
                               FaultPlan(seed=0, kill_at={2: 5}), 0.75)):
        out = run_fleet(
            lambda role, rank: Engine(mcfg, state, **geo),
            list(synthetic_requests(cfg, mcfg.vocab_size)), prefill=1, decode=2,
            heartbeat_s=0.05, lease_s=lease, fault_plan=plan, job_timeout_s=300.0,
        )
        torch.cuda.empty_cache()
        diff = sorted(r for r in want if out["completed"].get(r) != want[r])
        if len(out["completed"]) != 4 or diff:
            fail(f"fleet parity f32, {name}: tokens differ from the Server's for {diff}")
        router = out["router"]
        if plan is not None and (router["requeues"] < 1 or out["fault_events"] != (("kill", 2, 5),)):
            fail(f"fleet parity f32, {name}: requeues {router['requeues']}, "
                 f"fault events {out.get('fault_events')}")
        results[name] = {"tokens": "identical", "evictions": router["evictions"],
                         "requeues": router["requeues"]}
    print(json.dumps({"parity_fleet_f32": results}), flush=True)
    return results


# ---- the convnet workloads (phases 4c, 4cd, 4cp, 5c) -------------------------

# The convnet profile's kernel families, matched in this order: cuDNN's
# convolution kernels (forward, data and weight gradients, and the input
# padding cuDNN adds; some carry "gemm" or "xmma" in their names, so they
# come before the GEMMs), the
# pools, cuBLAS's GEMMs (the dense layers), the goo rules' foreach
# kernels, copies and casts, the elementwise passes (ReLU, bias adds, the
# loss) and the layout transposes cuDNN may add.
CONV_FAMILIES = {
    "convolution": ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft", "cudnn",
                    "padding"),
    "pooling": ("pool",),
    "gemm": ("nvjet", "gemm", "xmma", "cutlass"),
    "optimizer_foreach": ("foreach", "multi_tensor"),
    "copies": ("copy",),
    "elementwise": ("elementwise", "vectorized", "reduce", "softmax", "index", "scatter",
                    "gather", "threshold", "fill"),
    "layout": ("nchwtonhwc", "nhwctonchw", "transpose", "permute"),
}


def convnet_bucket_plans(torch) -> dict:
    """AlexNet's, LeNet's and ResNet-50's flat lengths over CONV_RANKS
    ranks, and their bucket plans at the default 4 MB."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.models import AlexNet, LeNet, ResNet50
    from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len
    from mpit_tpu_torch.train.grad_sync import GradSync

    world = comm.init({"data": CONV_RANKS}, devices=["cuda"])
    plans = {}
    nets = (("alexnet", AlexNet(device="meta")), ("lenet", LeNet(device="meta")),
            ("resnet50", ResNet50(device="meta")))
    for net, model in nets:
        layout = FlatLayout(dict(model.named_parameters()))
        rows = padded_len(layout.total, CONV_RANKS) // (CONV_RANKS * 128)
        buckets = GradSync(world, "ring").bucket_rows(rows)
        plans[net] = {"flat_len": layout.total, "shard_rows": rows, "buckets": len(buckets),
                      "first_bucket_rows": buckets[0][1] - buckets[0][0],
                      "tail_rows": buckets[-1][1] - buckets[-1][0]}
    if plans["alexnet"]["flat_len"] != ALEXNET_FLAT:
        fail(f"AlexNet's flat layout holds {plans['alexnet']['flat_len']}, not {ALEXNET_FLAT}")
    if plans["resnet50"]["flat_len"] != RESNET_FLAT:
        fail(f"ResNet-50's flat layout holds {plans['resnet50']['flat_len']}, not {RESNET_FLAT}")
    return plans


def falling(losses) -> tuple[float, float]:
    """The means of the first and the last five losses."""
    import numpy as np

    return float(np.mean(losses[:5])), float(np.mean(losses[-5:]))


def convnet_one_rank_phase(torch, card) -> dict:
    """Phase 4c: ``imagenet`` at full width on one rank (the loop's
    images/s, which the host's data stream sets; step p50; peak memory),
    the same step timed over two batches staged on the card, a profile of
    three steps, and ``mnist`` (config #1's model, SPMD)."""
    import numpy as np

    from mpit_tpu_torch.asyncsgd import imagenet, mnist

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = imagenet.main(IMAGENET_ARGS + ["--steps", str(IMAGENET_STEPS)])
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if out["steps"] != IMAGENET_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"imagenet one rank: {out['steps']} steps, losses {losses}")
    first, last = falling(losses)
    if not last < first:
        fail(f"imagenet one rank: the last five losses' mean {last} >= the first five's {first}")
    step_ms = np.asarray(out["step_ms"][2:])
    p50 = float(np.percentile(step_ms, 50))
    record = {
        "args": IMAGENET_ARGS + ["--steps", str(IMAGENET_STEPS)], "steps": out["steps"],
        "losses": losses, "first5_mean": first, "last5_mean": last, "eval": out["eval"],
        # The loop's best window can be a burst of the prefetched batches;
        # the sustained rate is the batch over the step p50.
        "images_per_sec_best_window": out.get("items_per_sec"),
        "images_per_sec_p50": 128 * 1e3 / p50,
        "step_ms_p50": p50, "step_ms_p95": float(np.percentile(step_ms, 95)),
        "peak_memory_gib": peak / 2**30, "wall_s": wall_s,
    }
    record.update(convnet_staged_step(torch))
    busy = record["profile_3_steps"].get("device_busy_ms_per_step")
    if busy is not None:  # the step's device work against its time
        record["staged_device_idle_share"] = max(0.0, 1 - busy / record["staged_step_ms"])
        record["loop_device_idle_share"] = max(0.0, 1 - busy / p50)
    print(json.dumps({"card": card, "train_imagenet": record}), flush=True)
    t0 = time.perf_counter()
    out = mnist.main(MNIST_ARGS)
    losses = out["losses"]
    if not (out["steps"] == 30 and out["final_loss"] < 0.5 < losses[0]
            and out["eval"]["top1"] > 0.7):
        fail(f"mnist one rank: steps {out['steps']}, losses {losses}, eval {out['eval']}")
    mrec = {"args": MNIST_ARGS, "losses": losses, "eval": out["eval"],
            "images_per_sec": out.get("items_per_sec"), "wall_s": time.perf_counter() - t0}
    print(json.dumps({"card": card, "train_mnist": mrec}), flush=True)
    return {"imagenet": record, "mnist": mrec}


def convnet_staged_step(torch, steps: int = 20, warmup: int = 5) -> dict:
    """The 4c step (AlexNet at full width, one rank, goo SGD lr 0.01
    momentum 0.9, batch 128) over two batches staged on the card,
    alternated: device ms a step from CUDA events after ``warmup``
    steps, and the profile of three steps (device time by kernel family,
    idle share). The host's data stream is out of this loop."""
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.asyncsgd.imagenet import ImagenetConfig
    from mpit_tpu_torch.data import synthetic_imagenet
    from mpit_tpu_torch.models import AlexNet
    from mpit_tpu_torch.train import make_train_step

    cfg = ImagenetConfig()
    model = AlexNet(device="cuda", generator=torch.Generator().manual_seed(0))
    loss_fn, _ = runner._classifier_fns(model, top5=False)
    init_fn, step_fn = make_train_step(loss_fn, runner.build_tx(cfg))
    state = {"s": init_fn(dict(model.named_parameters()))}
    stream = synthetic_imagenet(num_classes=cfg.num_classes, seed=0).batches(128)
    staged = [{k: torch.from_numpy(v).cuda() for k, v in next(stream).items()}
              for _ in range(2)]

    def one_step(b):
        state["s"], _ = step_fn(state["s"], b)

    for i in range(warmup):
        one_step(staged[i % 2])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(steps):
        one_step(staged[i % 2])
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    ms = start.elapsed_time(end) / steps
    profile = profile_window(torch, one_step, [staged[i % 2] for i in range(3)],
                             families=CONV_FAMILIES)
    del model, state, staged
    torch.cuda.empty_cache()
    return {"staged_step_ms": ms, "staged_images_per_sec": 128 * 1e3 / ms,
            "staged_wall_ms_per_step": host_ms, "staged_steps": steps,
            "profile_3_steps": profile}


def convnet_dp_phase(torch, card, plans: dict, runs: dict | None = None) -> dict:
    """Phase 4cd: ``imagenet --mesh data=4 --zero1 true`` through ``ring``
    and ``ring_q8`` (global batch 128, 20 steps), and ``mnist --mesh
    data=4 --grad-sync ring`` (config #2): finite losses, the replicas
    bit-identical (with a BatchNorm model, its buffers too), the ring
    launches (set to 0 just before) buckets x steps for the run's kinds
    and 0 for the others, the q8 launches on the forms the plan names.
    ``runs`` replaces the runs (phase 4rd's). Returns each run's
    launches by kernel."""
    import numpy as np

    from mpit_tpu_torch.asyncsgd import imagenet, mnist
    from mpit_tpu_torch.ops import ring_collectives as rc

    runs = runs or {
        "imagenet_ring": (imagenet.main, "alexnet", "ring", IMAGENET_DP_STEPS,
                          IMAGENET_ARGS + ["--steps", str(IMAGENET_DP_STEPS)]),
        "imagenet_ring_q8": (imagenet.main, "alexnet", "ring_q8", IMAGENET_DP_STEPS,
                             IMAGENET_ARGS + ["--steps", str(IMAGENET_DP_STEPS)]),
        "mnist_ring": (mnist.main, "lenet", "ring", 30, MNIST_ARGS),
    }
    learns = {"mnist_ring": lambda o: o["final_loss"] < 0.5 < o["losses"][0]}
    launches = {}
    for name, (main, net, mode, steps, args) in runs.items():
        args = args + ["--mesh", f"data={CONV_RANKS}", "--zero1", "true", "--grad-sync", mode]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rc.launches.update(dict.fromkeys(rc.launches, 0))
        rc.path_launches.update(dict.fromkeys(rc.path_launches, 0))
        t0 = time.perf_counter()
        out = main(args)
        wall_s = time.perf_counter() - t0
        ring, forms = dict(rc.launches), dict(rc.path_launches)
        losses = out["losses"]
        if out["steps"] != steps or not all(math.isfinite(x) for x in losses):
            fail(f"{name}: {out['steps']} steps, losses {losses}")
        if not out["replicas_identical"]:
            fail(f"{name}: the {CONV_RANKS} parameter replicas differ after the run")
        if not learns.get(name, lambda o: True)(out):
            fail(f"{name}: losses {losses} do not fall below 0.5")
        if out["grad_sync"] != mode:
            fail(f"{name}: the step ran {out['grad_sync']}")
        plan = plans[net]
        q = "_q8" if mode == "ring_q8" else ""
        want = {k: plan["buckets"] * steps if k in (f"ring_rs{q}", f"ring_ag{q}") else 0
                for k in ring}
        if ring != want:
            fail(f"{name}: ring launches {ring}, expected {want}")
        want_forms = dict.fromkeys(forms, 0)
        if q:
            sizes = [plan["first_bucket_rows"]] * (plan["buckets"] - 1) + [plan["tail_rows"]]
            for rows in sizes:
                for kind in ("ring_rs_q8", "ring_ag_q8"):
                    form = rc.q8_plan(kind, CONV_RANKS, rows, torch.float32,
                                      torch.device("cuda", 0))["form"]
                    want_forms[form] += steps
        if forms != want_forms:
            fail(f"{name}: q8 launches by form {forms}, expected {want_forms}")
        launches[name] = {k: n for k, n in ring.items() if n}
        step_ms = np.asarray(out["step_ms"][2:])
        print(json.dumps({"card": card, "train_convnet_dp": {
            "run": name, "args": args, "steps": steps, "losses": losses,
            "first5_mean": falling(losses)[0], "last5_mean": falling(losses)[1],
            "eval": out["eval"], "images_per_sec_best_window": out.get("items_per_sec"),
            "images_per_sec_p50": int(args[args.index("--batch-size") + 1]) * 1e3
            / float(np.percentile(step_ms, 50)),
            "step_ms_p50": float(np.percentile(step_ms, 50)),
            "step_ms_p95": float(np.percentile(step_ms, 95)),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall_s,
            "replicas_identical": True, "bucket_plan": plan, "ring_launches": ring,
            "first_loss": losses[0], "last_loss": losses[-1],
            "q8_launches_by_form": forms,
        }}), flush=True)
    return launches


def convnet_parity_phase(torch, card) -> dict:
    """Phase 4cp: mpiT's pserver/pclient protocol on the card (config #1
    literally; five ranks with EASGD; config #3 at full width). Every
    flat message is two launches of the copy kernel (the send snapshot
    and the delivery): a Downpour client step four (the fetch's reply and
    the gradient), an EASGD exchange four (the client's parameters and
    the reply). The launches of each run (set to 0 just before) must be
    exactly that; the ps_msgs counters and wall time are reported.
    Returns the launches by run."""
    from mpit_tpu_torch import obs
    from mpit_tpu_torch.asyncsgd import imagenet, mnist
    from mpit_tpu_torch.ops import kv_ship

    runs = {  # name: (main, args, check)
        "mnist_parity_downpour_2": (mnist.main, ["--mode", "parity", "--nranks", "2",
                                                 "--steps", "40", "--batch-size", "32"],
                                    lambda o: o["final_loss"] < o["first_loss"]
                                    and o["eval"]["accuracy"] > 0.5),
        "mnist_parity_easgd_5": (mnist.main, ["--mode", "parity", "--nranks", "5",
                                              "--steps", "60", "--batch-size", "32",
                                              "--easgd", "true", "--sync-every", "4"],
                                 lambda o: o["final_loss"] < o["first_loss"]),
        "imagenet_parity_downpour_5": (imagenet.main, ["--mode", "parity", "--nranks", "5",
                                                       "--steps", "8", "--batch-size", "128",
                                                       "--eval-batch", "128"],
                                       lambda o: all(math.isfinite(x) for x in o["losses"])),
    }
    launches = {}
    for name, (main, args, check) in runs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kv_ship.launches["kv_ship"] = 0
        kv_ship.path_launches.update(dict.fromkeys(kv_ship.path_launches, 0))
        rec = obs.enable(obs.Recorder())
        try:
            out = main(args)
        finally:
            obs.disable()
        torch.cuda.synchronize()
        n, bodies = kv_ship.launches["kv_ship"], dict(kv_ship.path_launches)
        if not check(out):
            fail(f"{name}: losses {out['losses']}, eval {out['eval']}")
        clients = int(args[args.index("--nranks") + 1]) - 1
        steps = int(args[args.index("--steps") + 1]) // clients
        if out["protocol"] == "easgd":
            sync = int(args[args.index("--sync-every") + 1])
            want = 4 * clients * (steps // sync)
        else:
            want = 4 * clients * steps
        if n != want:
            fail(f"{name}: {n} copy-kernel launches, expected {want}")
        msgs = {}
        for (cname, attrs), v in rec.snapshot()["counters"].items():
            if cname == "ps_msgs":
                a = dict(attrs)
                msgs[f"{a['role']}/{a['kind']}"] = int(v)
        launches[name] = n
        print(json.dumps({"card": card, "train_parity": {
            "run": name, "args": args, "protocol": out["protocol"], "losses": out["losses"],
            "first_loss": out["first_loss"], "final_loss": out["final_loss"],
            "eval": out["eval"], "flat_len": out["flat_len"],
            "message_bytes": out["flat_len"] * 4, "wall_s": out["wall_s"],
            "kv_ship_launches": n, "kv_ship_by_body": bodies, "ps_msgs": msgs,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }}), flush=True)
    return launches


def convnet_parity_f32_phase(torch) -> dict:
    """Phase 5c: f32 (TF32 off, cuDNN deterministic, no autotuning), three
    goo SGD steps from one seeded port initialisation over the same
    global batches: LeNet (batch 32, lr 0.05) and AlexNet at image 128
    with 8 classes (batch 32, lr 0.01). ``ring`` against ``psum`` at p 4
    within CONV_PARITY_TOL, ``ring_q8`` within ``0.02 + 0.02·|loss|`` of
    ``psum`` (the JAX package's pin), and one rank against the four
    ranks' ``psum`` within CONV_RANKS_TOL."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.data import shard_batch, synthetic_imagenet, synthetic_mnist
    from mpit_tpu_torch.models import AlexNet, LeNet
    from mpit_tpu_torch.opt import goo
    from mpit_tpu_torch.train import make_train_step

    nets = {
        "lenet": (lambda **kw: LeNet(**kw), synthetic_mnist(seed=0), 0.05),
        "alexnet_128_c8": (lambda **kw: AlexNet(8, torch.float32, image_size=128, **kw),
                           synthetic_imagenet(image_size=128, num_classes=8, seed=0), 0.01),
    }
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out = {}
    try:
        for net, (make, ds, lr) in nets.items():
            init = make(generator=torch.Generator().manual_seed(0)).state_dict()
            stream = ds.batches(32)
            batches = [next(stream) for _ in range(3)]
            losses = {}
            for mode in ("one_rank", "psum", "ring", "ring_q8"):
                p = 1 if mode == "one_rank" else CONV_RANKS
                models = [make(device="cuda") for _ in range(p)]
                for m in models:
                    m.load_state_dict(init)
                fns = [runner._classifier_fns(m, top5=False)[0] for m in models]
                world = None if p == 1 else comm.init({"data": p}, devices=["cuda"])
                init_fn, step_fn = make_train_step(
                    fns[0] if world is None else fns, goo(lr, 0.9), world,
                    grad_sync="psum" if p == 1 else mode,
                )
                named = [dict(m.named_parameters()) for m in models]
                state = init_fn(named[0] if world is None else named)
                losses[mode] = []
                for b in batches:
                    b = ({k: torch.from_numpy(v).cuda() for k, v in b.items()}
                         if world is None else shard_batch(world, b))
                    state, m = step_fn(state, b)
                    losses[mode].append(m["loss"].item())
                if not state.replicas_equal():
                    fail(f"parity f32 {net} {mode}: replicas differ")
                del models, state, step_fn
                torch.cuda.empty_cache()
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses["ring"], losses["psum"]))
            if not rel <= CONV_PARITY_TOL:
                fail(f"parity f32 {net}: ring {losses['ring']} vs psum {losses['psum']}")
            gaps = [abs(a - b) for a, b in zip(losses["psum"], losses["ring_q8"])]
            if any(g > 0.02 + 0.02 * abs(a) for a, g in zip(losses["psum"], gaps)):
                fail(f"parity f32 {net}: ring_q8 {losses['ring_q8']} vs psum {losses['psum']}")
            one = max(abs(a - b) / abs(b) for a, b in zip(losses["one_rank"], losses["psum"]))
            if not one <= CONV_RANKS_TOL:
                fail(f"parity f32 {net}: one rank {losses['one_rank']} vs four {losses['psum']}")
            out[net] = {"losses": losses, "ring_max_rel_diff": rel,
                        "ring_q8_max_abs_gap": max(gaps), "one_rank_max_rel_diff": one}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    print(json.dumps({"convnet_parity_f32": out}), flush=True)
    return out


def convnet_phases(torch, card, plans: dict) -> dict:
    """Phases 4c, 4cd, 4cp and 5c in turn; their records also go to
    ``chiprun_out/chip_smoke_convnets.json``. Returns the main paths'
    launches: the ring kernels' by run and kernel, the copy kernel's by
    run."""
    t0 = time.perf_counter()
    one = convnet_one_rank_phase(torch, card)
    print(f"phase 4c: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ring = convnet_dp_phase(torch, card, plans)
    print(f"phase 4cd: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ship = convnet_parity_phase(torch, card)
    print(f"phase 4cp: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    parity = convnet_parity_f32_phase(torch)
    print(f"phase 5c: {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {"ring": ring, "kv_ship": ship}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_convnets.json").write_text(json.dumps(
        {"card": card, "bucket_plans": plans, "one_rank": one, "launches": launches,
         "parity_f32": parity}, indent=1))
    return {"launches": launches}


# ---- ResNet-50 (phases 4r, 4rd, 5r) ---------------------------------------------

# The ResNet profile's kernel families, matched in this order: cuDNN's
# convolutions, the pools, the reductions (BatchNorm's sums of x and x²
# and of their gradients, the mean pool, the loss), the goo rules'
# foreach kernels, copies and casts (the norms' f32 copies of the
# activations among them), the elementwise passes (the norms'
# scale-shift and its gradient, ReLUs, residual adds), GEMMs (the head)
# and layout transposes.
RESNET_FAMILIES = {
    "convolution": CONV_FAMILIES["convolution"],
    "pooling": ("pool",),
    "reductions": ("reduce",),
    "optimizer_foreach": ("foreach", "multi_tensor"),
    "copies": ("copy",),
    "elementwise": ("elementwise", "vectorized", "softmax", "index", "scatter", "gather",
                    "threshold", "fill"),
    "gemm": ("nvjet", "gemm", "xmma", "cutlass"),
    "layout": ("nchwtonhwc", "nhwctonchw", "transpose", "permute"),
}


def resnet_one_rank_phase(torch, card) -> dict:
    """Phase 4r: ``resnet`` at full width on one rank (RESNET_ARGS,
    RESNET_STEPS steps): finite losses and a finite eval through the
    running statistics; the loop's images/s at the step p50 (the host's
    synthetic stream sets it), step p50/p95, peak memory; then the step
    over batches staged on the card (:func:`resnet_staged_step`)."""
    import numpy as np

    from mpit_tpu_torch.asyncsgd import resnet

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = RESNET_ARGS + ["--steps", str(RESNET_STEPS)]
    t0 = time.perf_counter()
    out = resnet.main(args)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = out["losses"]
    if out["steps"] != RESNET_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"resnet one rank: {out['steps']} steps, losses {losses}")
    if set(out["eval"]) != {"loss", "top1", "top5"} or not all(
            math.isfinite(v) for v in out["eval"].values()):
        fail(f"resnet one rank: eval {out['eval']}")
    step_ms = np.asarray(out["step_ms"][2:])
    p50 = float(np.percentile(step_ms, 50))
    record = {
        "args": args, "steps": out["steps"], "losses": losses, "first_loss": losses[0],
        "last_loss": losses[-1], "first5_mean": falling(losses)[0],
        "last5_mean": falling(losses)[1], "eval": out["eval"],
        "images_per_sec_best_window": out.get("items_per_sec"),
        "images_per_sec_p50": 128 * 1e3 / p50,
        "step_ms_p50": p50, "step_ms_p95": float(np.percentile(step_ms, 95)),
        "peak_memory_gib": peak / 2**30, "wall_s": wall_s,
    }
    record.update(resnet_staged_step(torch))
    busy = record["profile_3_steps"].get("device_busy_ms_per_step")
    if busy is not None:
        record["staged_device_idle_share"] = max(0.0, 1 - busy / record["staged_step_ms"])
        record["loop_device_idle_share"] = max(0.0, 1 - busy / p50)
    print(json.dumps({"card": card, "train_resnet": record}), flush=True)
    return record


def resnet_staged_step(torch, steps: int = 20, warmup: int = 5) -> dict:
    """The 4r step (ResNet-50 at full width, one rank, batch 128) over two
    batches made on the card from a seed, alternated: device ms a step
    from CUDA events after ``warmup`` steps, the peak memory of the step
    alone, and the profile of three steps (device time by RESNET_FAMILIES
    family, idle share). The host's data stream is out of this loop."""
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.asyncsgd.resnet import ResnetConfig
    from mpit_tpu_torch.models import ResNet50
    from mpit_tpu_torch.train import make_train_step

    cfg = ResnetConfig()
    model = ResNet50(device="cuda", generator=torch.Generator().manual_seed(0))
    loss_fn, _ = runner._classifier_fns(model, top5=False, stateful=True)
    init_fn, step_fn = make_train_step(loss_fn, runner.build_tx(cfg), stateful=True)
    state = {"s": init_fn(dict(model.named_parameters()), dict(model.named_buffers()))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    staged = [{"image": torch.randn(128, cfg.image_size, cfg.image_size, 3, device="cuda",
                                    generator=gen),
               "label": torch.randint(0, cfg.num_classes, (128,), device="cuda",
                                      generator=gen)} for _ in range(2)]

    def one_step(b):
        state["s"], _ = step_fn(state["s"], b)

    for i in range(warmup):
        one_step(staged[i % 2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(steps):
        one_step(staged[i % 2])
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    ms = start.elapsed_time(end) / steps
    peak = torch.cuda.max_memory_allocated()
    profile = profile_window(torch, one_step, [staged[i % 2] for i in range(3)],
                             families=RESNET_FAMILIES)
    del model, state, staged
    torch.cuda.empty_cache()
    return {"staged_step_ms": ms, "staged_images_per_sec": 128 * 1e3 / ms,
            "staged_wall_ms_per_step": host_ms, "staged_steps": steps,
            "staged_peak_memory_gib": peak / 2**30, "profile_3_steps": profile}


def resnet_parity_f32_phase(torch) -> dict:
    """Phase 5r: f32 (TF32 off, cuDNN deterministic, no autotuning),
    three goo SGD steps (lr 0.01, momentum 0.9, weight decay 1e-4) of
    ResNet-50 at 64 x 64 with 8 classes from one seeded port
    initialisation, over CONV_RANKS ranks with eight images each:
    ``ring`` within RESNET_PARITY_TOL of ``psum`` (losses) and
    RESNET_STATS_TOL (every BatchNorm buffer), ``ring_q8`` within ``0.02
    + 0.02·|loss|`` of ``psum`` (the JAX package's pin); the replicas,
    parameters and buffers, bit-identical in every mode."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.data import shard_batch, synthetic_imagenet
    from mpit_tpu_torch.models import ResNet50
    from mpit_tpu_torch.opt import goo
    from mpit_tpu_torch.train import make_train_step

    def make(**kw):
        return ResNet50(8, torch.float32, norm_dtype=torch.float32, **kw)

    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        init = make(generator=torch.Generator().manual_seed(0)).state_dict()
        stream = synthetic_imagenet(image_size=64, num_classes=8, seed=0).batches(8 * CONV_RANKS)
        batches = [next(stream) for _ in range(3)]
        losses, stats = {}, {}
        world = comm.init({"data": CONV_RANKS}, devices=["cuda"])
        for mode in ("psum", "ring", "ring_q8"):
            models = [make(device="cuda") for _ in range(CONV_RANKS)]
            for m in models:
                m.load_state_dict(init)
            fns = [runner._classifier_fns(m, top5=False, stateful=True)[0] for m in models]
            init_fn, step_fn = make_train_step(fns, goo(0.01, 0.9, weight_decay=1e-4), world,
                                               stateful=True, grad_sync=mode)
            state = init_fn([dict(m.named_parameters()) for m in models],
                            [dict(m.named_buffers()) for m in models])
            losses[mode] = []
            for b in batches:
                state, m = step_fn(state, shard_batch(world, b))
                losses[mode].append(m["loss"].item())
            if not state.replicas_equal():
                fail(f"parity f32 resnet {mode}: replicas differ")
            stats[mode] = {k: v.clone() for k, v in models[0].named_buffers()}
            del models, state, step_fn
            torch.cuda.empty_cache()
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["ring"], losses["psum"]))
        if not rel <= RESNET_PARITY_TOL:
            fail(f"parity f32 resnet: ring {losses['ring']} vs psum {losses['psum']}")
        stats_rel = max(
            (stats["ring"][k] - v).abs().max().item() / max(1.0, v.abs().max().item())
            for k, v in stats["psum"].items())
        if not stats_rel <= RESNET_STATS_TOL:
            fail(f"parity f32 resnet: ring's statistics part from psum's by {stats_rel}")
        if all(torch.equal(stats["psum"][k], torch.zeros_like(v) if k.endswith("mean")
                           else torch.ones_like(v)) for k, v in stats["psum"].items()):
            fail("parity f32 resnet: the running statistics never moved")
        gaps = [abs(a - b) for a, b in zip(losses["psum"], losses["ring_q8"])]
        if any(g > 0.02 + 0.02 * abs(a) for a, g in zip(losses["psum"], gaps)):
            fail(f"parity f32 resnet: ring_q8 {losses['ring_q8']} vs psum {losses['psum']}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
    out = {"losses": losses, "ring_max_rel_diff": rel, "ring_stats_max_rel_diff": stats_rel,
           "ring_q8_max_abs_gap": max(gaps)}
    print(json.dumps({"resnet_parity_f32": out}), flush=True)
    return out


def resnet_phases(torch, card, plans: dict) -> dict:
    """Phases 4r, 4rd and 5r in turn; their records also go to
    ``chiprun_out/chip_smoke_resnet.json``. Returns 4rd's ring launches
    by run and kernel."""
    from mpit_tpu_torch.asyncsgd import resnet

    t0 = time.perf_counter()
    one = resnet_one_rank_phase(torch, card)
    print(f"phase 4r: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    args = RESNET_ARGS + ["--steps", str(RESNET_DP_STEPS)]
    ring = convnet_dp_phase(torch, card, plans, runs={
        f"resnet_{mode}": (resnet.main, "resnet50", mode, RESNET_DP_STEPS, args)
        for mode in ("ring", "ring_q8")})
    print(f"phase 4rd: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    parity = resnet_parity_f32_phase(torch)
    print(f"phase 5r: {time.perf_counter() - t0:.1f} s", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_resnet.json").write_text(json.dumps(
        {"card": card, "bucket_plan": plans["resnet50"], "one_rank": one, "launches": ring,
         "parity_f32": parity}, indent=1))
    return {"launches": ring}


# ---- checkpoints, the dense format and the elastic tier (4k, 4kd, 4kx, 4e) ----------

RECOVERY_MNIST_ARGS = ["--batch-size", "32", "--log-every", "1"]
RECOVERY_MNIST_STEPS = 20
RECOVERY_ALEXNET_STEPS = 8
# 4kx: GPT-2 small at full width, seq 512, batch 8, the flash kernels,
# ZeRO-1 through the ring kernels; the data=2 continuation of a data=4
# run against the uninterrupted data=4 run. Absolute, per-step loss: the
# ranks' GEMMs run at half the rows (cuBLAS's bf16 results are not
# row-invariant in M), and Adam turns the sign noise of near-zero
# gradients into steps of up to lr.
GPT2_DENSE_ARGS = ["--flash", "true", "--log-every", "1", "--zero1", "true",
                   "--grad-sync", "ring"]
GPT2_DENSE_STEPS = 6
GPT2_DENSE_TOL = 2e-2
# 4e: four LeNet replicas at full width, 60 steps of 32 images each,
# an exchange every 4 steps, alpha = 0.5 / N_active; JAX's liveness
# defaults (heartbeat 0.1 s, lease 1.0 s).
ELASTIC_ARGS = ["--mode", "elastic", "--nranks", "5", "--batch-size", "128", "--steps", "240",
                "--sync-every", "4", "--easgd-beta", "0.5", "--log-every", "10",
                "--eval-batch", "256"]


class deterministic:
    """5c's settings for the enclosed block: TF32 off, cuDNN
    deterministic, no autotuning; restored after."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        b = self.torch.backends
        self.saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
                      b.cudnn.benchmark)
        b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
        b.cudnn.deterministic, b.cudnn.benchmark = True, False

    def __exit__(self, *exc):
        b = self.torch.backends
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = self.saved


class model_hook:
    """A forward pre-hook on every module for the enclosed block: keeps
    the instances of ``cls`` in the order they first run (rank 0's model
    first), and with ``sigterm_at`` sends this process a SIGTERM from the
    main thread during rank 0's ``sigterm_at``-th forward (its step
    ``sigterm_at``, which then finishes)."""

    def __init__(self, torch, cls, sigterm_at: int = 0):
        self.torch, self.cls, self.sigterm_at = torch, cls, sigterm_at
        self.models, self.calls = [], 0

    def __call__(self, module, args):
        import os
        import signal

        if not isinstance(module, self.cls):
            return None
        if not any(m is module for m in self.models):
            self.models.append(module)
        if module is self.models[0]:
            self.calls += 1
            if self.calls == self.sigterm_at:
                os.kill(os.getpid(), signal.SIGTERM)
        return None

    def __enter__(self):
        self.handle = self.torch.nn.modules.module.register_module_forward_pre_hook(self)
        return self

    def __exit__(self, *exc):
        self.handle.remove()


def rank0_params(model) -> dict:
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()}


def ckpt_steps(path) -> list:
    from mpit_tpu_torch.train import AtomicCheckpoint

    return AtomicCheckpoint(path).all_steps()


def recovery_resume_phase(torch, card, plans: dict, tmp) -> dict:
    """Phase 4k: ``mnist`` on one rank and ``imagenet`` (AlexNet at full
    width) over four ranks through ``ring``, each with ``--ckpt-dir``:
    an uninterrupted run of N steps, and a run stopped at N/2 by a
    SIGTERM from the main thread's step hook, then resumed to N. Under
    5c's settings the resumed losses and the final parameters equal the
    uninterrupted run's bit for bit and the replicas are equal; the ring
    launches are buckets x steps in every run. Returns each run's ring
    launches."""
    from mpit_tpu_torch.asyncsgd import imagenet, mnist
    from mpit_tpu_torch.models import AlexNet, LeNet
    from mpit_tpu_torch.ops import ring_collectives as rc

    runs = {  # name: (main, model class, args, N, bucket plan)
        "mnist": (mnist.main, LeNet, RECOVERY_MNIST_ARGS, RECOVERY_MNIST_STEPS, None),
        "imagenet_ring": (imagenet.main, AlexNet,
                          IMAGENET_ARGS + ["--mesh", f"data={CONV_RANKS}", "--zero1", "true",
                                           "--grad-sync", "ring"],
                          RECOVERY_ALEXNET_STEPS, plans["alexnet"]),
    }
    launches, records = {}, {}
    for name, (main, cls, args, n, plan) in runs.items():
        every = ["--ckpt-every", str(n // 2)]
        out, params, wall = {}, {}, {}
        for part, extra, hook_at in (
            ("full", ["--steps", str(n), "--ckpt-dir", str(tmp / f"{name}_full")], 0),
            ("stopped", ["--steps", str(n), "--ckpt-dir", str(tmp / name)], n // 2),
            ("resumed", ["--steps", str(n), "--ckpt-dir", str(tmp / name)], 0),
        ):
            torch.cuda.empty_cache()
            rc.launches.update(dict.fromkeys(rc.launches, 0))
            t0 = time.perf_counter()
            with deterministic(torch), model_hook(torch, cls, hook_at) as hook:
                out[part] = main(args + every + extra)
            torch.cuda.synchronize()
            wall[part] = time.perf_counter() - t0
            params[part] = rank0_params(hook.models[0])
            ran = out[part]["steps"] - (n // 2 if part == "resumed" else 0)
            if plan is not None:
                want = {k: plan["buckets"] * ran if k in ("ring_rs", "ring_ag") else 0
                        for k in rc.launches}
                if dict(rc.launches) != want:
                    fail(f"4k {name} {part}: ring launches {dict(rc.launches)}, expected {want}")
                launches[f"{name}_{part}"] = {k: v for k, v in rc.launches.items() if v}
                if not out[part]["replicas_identical"]:
                    fail(f"4k {name} {part}: the replicas differ")
            del hook
        full, stopped, resumed = out["full"], out["stopped"], out["resumed"]
        if not (stopped["preempted"] and stopped["steps"] == n // 2):
            fail(f"4k {name}: the SIGTERM run ended at {stopped['steps']}, "
                 f"preempted {stopped['preempted']}")
        if ckpt_steps(tmp / name) != [n // 2, n]:
            fail(f"4k {name}: checkpoints {ckpt_steps(tmp / name)}, expected {[n // 2, n]}")
        if stopped["losses"] + resumed["losses"] != full["losses"]:
            fail(f"4k {name}: losses {stopped['losses']} + {resumed['losses']} != "
                 f"{full['losses']}")
        diff = [k for k, v in params["full"].items() if not torch.equal(v, params["resumed"][k])]
        if diff:
            fail(f"4k {name}: the resumed run's parameters differ at {diff[:4]}")
        if not all(math.isfinite(x) for x in full["losses"]):
            fail(f"4k {name}: losses {full['losses']}")
        records[name] = {
            "args": args + every, "steps": n, "stopped_at": stopped["steps"],
            "losses": full["losses"], "resumed_bit_equal": True,
            "checkpoints": ckpt_steps(tmp / name),
            "wall_s": wall, "ring_launches": {p: launches.get(f"{name}_{p}") for p in out},
        }
        print(json.dumps({"card": card, "recovery_resume": {name: records[name]}}), flush=True)
        for path in (tmp / name, tmp / f"{name}_full"):
            for f in path.iterdir():
                f.unlink()
    return {"launches": launches, "records": records}


def save_timing(torch, name: str, state) -> dict:
    """One state's checkpoint: the time ``save`` holds the step
    (asynchronous and synchronous), ``wait()``, ``restore`` into the
    state's own tensors, and the file's size. The parameters are set to
    one random row on every rank first."""
    import os
    import tempfile
    from pathlib import Path as _P

    from mpit_tpu_torch.train import CheckpointManager

    fp = state.flat.params
    fp.copy_(torch.empty(fp.shape[1], device=fp.device).uniform_(-0.1, 0.1).expand_as(fp))
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for mode, async_save in (("async", True), ("sync", False)):
            ck = CheckpointManager(_P(d) / mode, async_save=async_save, max_to_keep=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(1, state)
            out[f"{mode}_save_holds_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ck.wait()
            out[f"{mode}_wait_ms"] = (time.perf_counter() - t0) * 1e3
            path = _P(d) / mode / "step_0000000001.npz"
            out["bytes"] = os.path.getsize(path)
            t0 = time.perf_counter()
            ck.restore(state)
            torch.cuda.synchronize()
            out[f"{mode}_restore_ms"] = (time.perf_counter() - t0) * 1e3
            ck.close()
            path.unlink()
    if state.flat is not None and not state.replicas_equal():
        fail(f"save timing {name}: the replicas differ after the restore")
    return out


def recovery_save_timing(torch, card) -> dict:
    """Phase 4k's checkpoint costs at full width: AlexNet over four ranks
    (goo momentum, ZeRO-1) and GPT-2 small over four (Adam, ZeRO-1), and
    GPT-2's dense file (``dense_from_dp`` + ``save_dense``, then
    ``load_dense`` + ``dp_from_dense``)."""
    import os
    import tempfile

    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd import runner
    from mpit_tpu_torch.models import GPT2, AlexNet, GPT2Config
    from mpit_tpu_torch.opt import goo, goo_adam
    from mpit_tpu_torch.train import (dense_from_dp, dp_from_dense, load_dense,
                                      make_train_step, save_dense)

    world = comm.init({"data": CONV_RANKS}, devices=["cuda"])
    out = {}
    models = [AlexNet(device="cuda") for _ in range(CONV_RANKS)]
    init_fn, _ = make_train_step([runner._classifier_fns(m, False)[0] for m in models],
                                 goo(0.01, 0.9), world, grad_sync="ring")
    state = init_fn([dict(m.named_parameters()) for m in models])
    out["alexnet_p4"] = save_timing(torch, "alexnet", state)
    del models, state, init_fn
    torch.cuda.empty_cache()
    mcfg = GPT2Config.small()
    models = [GPT2(mcfg, device="cuda") for _ in range(CONV_RANKS)]
    tx = goo_adam(3e-4)
    init_fn, _ = make_train_step([lambda p, b: None] * CONV_RANKS, tx, world)
    state = init_fn([dict(m.named_parameters()) for m in models])
    out["gpt2_small_adam_p4"] = save_timing(torch, "gpt2", state)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "g.npz")
        t0 = time.perf_counter()
        save_dense(path, dense_from_dp(state, tx), num_heads=12, tie_head=True)
        dense = {"save_ms": (time.perf_counter() - t0) * 1e3, "bytes": os.path.getsize(path)}
        t0 = time.perf_counter()
        dp_from_dense(load_dense(path), state, tx)
        torch.cuda.synchronize()
        dense["load_ms"] = (time.perf_counter() - t0) * 1e3
    out["gpt2_small_adam_dense"] = dense
    del models, state
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "checkpoint_costs": out}), flush=True)
    return out


def recovery_divergence_phase(torch, card, tmp) -> dict:
    """Phase 4kd: ``mnist`` with ``--ckpt-dir``, a loss made non-finite
    at a chosen step (rank 0's input poisoned by a forward hook): the
    loop restores the newest checkpoint older than the target, logs it
    and completes; every checkpoint left holds finite values (none was
    written at a failing step). Poisoned twice with ``--max-restores
    1``, the run raises ``Diverged``."""
    import numpy as np

    from mpit_tpu_torch.asyncsgd import mnist
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.train import Diverged

    def poison(at):
        calls = {"n": 0}

        def hook(module, args):
            if isinstance(module, LeNet):
                calls["n"] += 1
                if calls["n"] in at:
                    return (args[0] * float("nan"),)
            return None

        return torch.nn.modules.module.register_module_forward_pre_hook(hook)

    args = ["--steps", str(RECOVERY_MNIST_STEPS), "--ckpt-every", "4", *RECOVERY_MNIST_ARGS]
    handle = poison({10})
    try:
        out = mnist.main(["--ckpt-dir", str(tmp / "div"), *args])
    finally:
        handle.remove()
    if not (out["restores"] == 1 and out["steps"] == RECOVERY_MNIST_STEPS
            and all(math.isfinite(x) for x in out["losses"])):
        fail(f"4kd: restores {out['restores']}, steps {out['steps']}, losses {out['losses']}")
    finite = {}
    for f in sorted((tmp / "div").glob("step_*.npz")):
        with np.load(f) as z:
            finite[f.name] = all(bool(np.isfinite(z[k]).all()) for k in z.files)
    if not all(finite.values()):
        fail(f"4kd: a checkpoint holds non-finite values: {finite}")
    handle = poison({10, 13})
    try:
        mnist.main(["--ckpt-dir", str(tmp / "div2"), "--max-restores", "1", *args])
        raised = None
    except Diverged as e:
        raised = str(e)
    finally:
        handle.remove()
    if raised is None:
        fail("4kd: two injections with --max-restores 1 did not raise Diverged")
    record = {"restores": out["restores"], "losses": out["losses"],
              "checkpoints_finite": finite, "second_injection_raised": raised}
    print(json.dumps({"card": card, "recovery_divergence": record}), flush=True)
    return record


def recovery_dense_phase(torch, card, tmp) -> dict:
    """Phase 4kx: GPT-2 small at full width over four ranks (ZeRO-1,
    ``ring``, the flash kernels): an uninterrupted run of 6 steps; a run
    of 3 with ``--save-dense``; its continuation to 6 on two ranks with
    ``--resume-dense`` (and ``--save-dense`` of the end), within
    GPT2_DENSE_TOL of the uninterrupted run. The final file through
    ``python -m mpit_tpu_torch.serve --ckpt``'s ``main`` (the decode
    kernel launched), and in f32: its parameters equal the trained rank
    0 model's bit for bit, and greedy tokens of an engine on the file
    equal those of an engine on the parameters in memory. Returns the
    runs' ring and flash launches."""
    import importlib

    from mpit_tpu_torch import comm
    from mpit_tpu_torch.asyncsgd import gpt2
    from mpit_tpu_torch.asyncsgd.config import from_argv
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import ring_collectives as rc
    from mpit_tpu_torch.opt.sharded import FlatLayout, padded_len
    from mpit_tpu_torch.serve import Engine, Request, Server
    from mpit_tpu_torch.serve.__main__ import main as serve_main
    from mpit_tpu_torch.serve.weights import load_gpt2_params
    from mpit_tpu_torch.train.grad_sync import GradSync

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    n, half = GPT2_DENSE_STEPS, GPT2_DENSE_STEPS // 2
    mcfg_run = from_argv(gpt2.GPT2TrainConfig, GPT2_DENSE_ARGS).model_config()
    layout_total = FlatLayout(dict(GPT2(mcfg_run, device="meta").named_parameters())).total

    def buckets(p):
        rows = padded_len(layout_total, p) // (p * 128)
        return len(GradSync(comm.init({"data": p}, devices=["cuda"]), "ring").bucket_rows(rows))

    half_path, final_path = str(tmp / "half.npz"), str(tmp / "final.npz")
    runs = {  # name: (p, args, steps run)
        "gpt2_dense_full_p4": (4, ["--steps", str(n)], n),
        "gpt2_dense_half_p4": (4, ["--steps", str(half), "--save-dense", half_path], half),
        "gpt2_dense_resumed_p2": (2, ["--steps", str(n), "--resume-dense", half_path,
                                      "--save-dense", final_path], n - half),
    }
    out, launches, wall = {}, {}, {}
    for name, (p, extra, ran) in runs.items():
        torch.cuda.empty_cache()
        rc.launches.update(dict.fromkeys(rc.launches, 0))
        fa.launches.update(dict.fromkeys(fa.launches, 0))
        t0 = time.perf_counter()
        with model_hook(torch, GPT2) as hook:
            out[name] = gpt2.main(GPT2_DENSE_ARGS + ["--mesh", f"data={p}"] + extra)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        want = {k: buckets(p) * ran if k in ("ring_rs", "ring_ag") else 0 for k in rc.launches}
        if dict(rc.launches) != want:
            fail(f"4kx {name}: ring launches {dict(rc.launches)}, expected {want}")
        per_step = mcfg_run.num_layers * p
        if any(v != per_step * ran for v in fa.launches.values()):
            fail(f"4kx {name}: flash launches {dict(fa.launches)}, expected {per_step * ran} each")
        if not out[name]["replicas_identical"]:
            fail(f"4kx {name}: the replicas differ")
        launches[name] = {**{k: v for k, v in rc.launches.items() if v},
                          **{f"flash_{k}": v for k, v in fa.launches.items()}}
        trained = rank0_params(hook.models[0])
        del hook
    full = out["gpt2_dense_full_p4"]["losses"]
    cont = out["gpt2_dense_half_p4"]["losses"] + out["gpt2_dense_resumed_p2"]["losses"]
    gaps = [abs(a - b) for a, b in zip(full, cont)]
    if len(cont) != n or max(gaps) > GPT2_DENSE_TOL:
        fail(f"4kx: the data=2 continuation {cont} against data=4 {full}")
    torch.cuda.empty_cache()
    da.launches.update(dict.fromkeys(da.launches, 0))
    served = serve_main(["--ckpt", final_path, "--requests", "8", "--max-new-tokens", "16",
                         "--slots", "4"])
    decode = {k: v for k, v in da.launches.items() if v}
    if served["requests_completed"] != 8 or not decode:
        fail(f"4kx: serve --ckpt completed {served['requests_completed']}, decode {decode}")
    state, mcfg = load_gpt2_params(final_path)
    diff = [k for k, v in trained.items() if not torch.equal(v, state[k])]
    if diff:
        fail(f"4kx: the dense file's parameters differ from the trained model's at {diff[:4]}")
    mcfg = dataclasses.replace(mcfg, dtype=torch.float32)
    prompts = [[(7 * i + j) % mcfg.vocab_size for j in range(4 + 2 * i)] for i in range(4)]

    def tokens(params):
        server = Server(Engine(mcfg, params, slots=4, max_len=24, prefill_len=16,
                               device="cuda"))
        for i, pr in enumerate(prompts):
            server.submit(Request(rid=i, prompt=pr, max_new_tokens=12))
        return {c.rid: c.tokens for c in server.run()}

    from_file, in_memory = tokens(state), tokens(trained)
    if from_file != in_memory:
        fail(f"4kx: f32 greedy tokens from the file {from_file} != in memory {in_memory}")
    record = {"args": GPT2_DENSE_ARGS, "losses_full_p4": full, "losses_half_then_p2": cont,
              "max_abs_gap": max(gaps), "tol": GPT2_DENSE_TOL, "wall_s": wall,
              "first_half_bit_equal": cont[:half] == full[:half],
              "launches": launches, "serve_decode_launches": decode,
              "serve_wall_s": served["wall_s"], "f32_tokens_equal": True,
              "tokens": sum(len(t) for t in from_file.values())}
    print(json.dumps({"card": card, "recovery_dense": record}), flush=True)
    return {"launches": launches, "record": record}


# 4e: a replica's training loss past this step above this value is a
# jump (PR 15's passing runs log at most 0.47 near step 50 of 60; the
# refused run logged 3 or more there).
JUMP_AFTER_STEP, JUMP_LOSS = 40, 1.0


class elastic_probe:
    """For the enclosed block: every replica's training loss at every
    step (around the loss function of each model the elastic runner
    builds, keyed by the compat rank's thread) and every exchange (the
    replica, its step, the centre version it had seen and the version the
    reply carried, taken before the server's update: their gap is the
    server's staleness). The
    elastic tier's results are left as JAX's are."""

    def __enter__(self):
        import threading

        from mpit_tpu_torch.asyncsgd import runner
        from mpit_tpu_torch.train import elastic

        self.losses, self.exchanges = {}, []
        self.runner, self.fns = runner, runner._classifier_fns
        self.client, self.exchange = elastic.AnchorClient, elastic.AnchorClient.exchange
        fns, exchange, probe = self.fns, self.exchange, self

        def classifier_fns(model, *a, **kw):
            loss_fn, eval_fn = fns(model, *a, **kw)

            def loss_and_record(params, batch):
                loss, aux = loss_fn(params, batch)
                name = threading.current_thread().name
                if name.startswith("mpit-rank-"):
                    probe.losses.setdefault(int(name.rsplit("-", 1)[1]), []).append(
                        loss.detach())
                return loss, aux

            return loss_and_record, eval_fn

        def exchange_and_record(client, flat, step):
            seen = client.version
            out = exchange(client, flat, step)
            probe.exchanges.append((client._rank, step, seen, client.version))
            return out

        runner._classifier_fns = classifier_fns
        elastic.AnchorClient.exchange = exchange_and_record
        return self

    def __exit__(self, *exc):
        self.runner._classifier_fns = self.fns
        self.client.exchange = self.exchange

    def record(self) -> dict:
        """Each replica's losses, its exchanges ``(step, version seen,
        staleness)`` and its jumps (losses past ``JUMP_AFTER_STEP`` above
        ``JUMP_LOSS``, as ``(step, loss)``)."""
        out = {}
        for rank in sorted(self.losses):
            losses = [float(x) for x in self.losses[rank]]
            out[rank] = {
                "losses": losses,
                "exchanges": [(st, seen, reply - seen)
                              for r, st, seen, reply in self.exchanges if r == rank],
                "jumps": [(i + 1, x) for i, x in enumerate(losses)
                          if i + 1 > JUMP_AFTER_STEP and x > JUMP_LOSS],
                "max_loss_after": max(losses[JUMP_AFTER_STEP:], default=None),
            }
        return out


def elastic_phase(torch, card, tmp) -> dict:
    """Phase 4e: ``mnist --mode elastic --nranks 5`` (four LeNet replicas
    and the anchor on the card) four ways: healthy (every staleness
    noted: ``--staleness-bound 0``), a kill with ``--ckpt-dir`` (crash,
    eviction, rejoin from the checkpoint), a hang past the lease
    (evict, then readmit) and a NaN (quarantine, restore, rejoin; the
    centre finite). The copy kernel's launches (set to 0 just before)
    must be exactly two a register or rejoin and four an exchange; the
    healthy run evicts nobody and its loss falls: the centre's eval loss
    on the 256 held-out images is below that of the initial parameters,
    and the median of replica 0's logged losses after its first two is
    below the mean of those two. (One logged loss is one 32-image batch:
    near zero loss a single confidently wrong image lifts it by several
    nats, so a pair of logged losses cannot judge the trend.) Returns
    the launches by run."""
    import numpy as np

    from mpit_tpu_torch.asyncsgd import mnist
    from mpit_tpu_torch.asyncsgd.runner import _on_device, softmax_xent
    from mpit_tpu_torch.compat import FaultPlan
    from mpit_tpu_torch.data import synthetic_mnist
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.ops import kv_ship

    # The centre's initial eval loss: the runner's seeded LeNet (seed 0)
    # on its eval batch (--eval-batch 256).
    with torch.no_grad():
        held_out = _on_device(synthetic_mnist(seed=0).eval_batch(256), "cuda")
        first = LeNet(num_classes=10, device="cuda", generator=torch.Generator().manual_seed(0))
        initial_eval = float(softmax_xent(first(held_out["image"]), held_out["label"]))
    del first, held_out

    runs = {  # name: (extra args, fault plan)
        "elastic_healthy": (["--staleness-bound", "0"], None),
        "elastic_kill_rejoin": (["--ckpt-dir", str(tmp / "kill"), "--ckpt-every", "10"],
                                FaultPlan(seed=0, kill_at={1: 35}, rejoin_delay_s=2.0)),
        "elastic_hang": ([], FaultPlan(seed=0, hang_at={2: (24, 2.5)})),
        "elastic_nan": (["--ckpt-dir", str(tmp / "nan"), "--ckpt-every", "10",
                         "--max-restores", "2"], FaultPlan(seed=0, nan_at={3: 21})),
    }
    launches, records = {}, {}
    for name, (extra, plan) in runs.items():
        kv_ship.launches["kv_ship"] = 0
        t0 = time.perf_counter()
        with elastic_probe() as probe:
            out = mnist.main(ELASTIC_ARGS + extra, fault_plan=plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        replicas = probe.record()
        n = kv_ship.launches["kv_ship"]
        server, stats = out["server"], out["replica_stats"]
        rejoins = sum(r["rejoins"] for r in stats)
        want = 2 * (len(stats) + rejoins) + 4 * out["anchor_version"]
        if n != want:
            fail(f"4e {name}: {n} copy-kernel launches, expected {want} (2 x ({len(stats)} "
                 f"registers + {rejoins} rejoins) + 4 x {out['anchor_version']} exchanges)")
        if out["anchor_version"] != sum(r["exchanges"] for r in stats):
            fail(f"4e {name}: version {out['anchor_version']} != the replicas' exchanges")
        if not all(r["completed"] for r in stats):
            fail(f"4e {name}: a replica did not complete: {stats}")
        kinds = [e[0] for e in server["events"]]
        head, later = float(np.mean(out["losses"][:2])), float(np.median(out["losses"][2:]))
        ok = {
            "elastic_healthy": lambda: server["evictions"] == 0
            and out["eval"]["loss"] < initial_eval and later < head,
            "elastic_kill_rejoin": lambda: stats[0]["crashes"] == 1
            and stats[0]["rejoin_steps_to_recover"] == 5 and "evicted" in kinds
            and ("rejoined", 1, "rejoin") in server["events"],
            "elastic_hang": lambda: [e[1] for e in server["events"] if e[0] == "evicted"] == [2]
            and any(e[0] == "rejoined" and e[1] == 2 for e in server["events"]),
            "elastic_nan": lambda: stats[2]["quarantines"] >= 1 and stats[2]["restores"] >= 1
            and server["evictions"] == 0 and math.isfinite(out["eval"]["loss"]),
        }[name]()
        if not ok:  # the short figures last: a log's tail keeps them
            fail(f"4e {name}: events {server['events']}, stats {stats}; evictions "
                 f"{server['evictions']}, the centre's eval {out['eval']} against "
                 f"{initial_eval} at init, replica 0's losses {out['losses']} (median after "
                 f"the first two {later}, mean of the first two {head})")
        stale = {}
        for e in server["events"]:
            if e[0] == "staleness_exceeded":
                stale.setdefault(e[1], []).append(e[2])
        launches[name] = n
        records[name] = {
            "args": ELASTIC_ARGS + extra, "wall_s": wall, "version": out["anchor_version"],
            "events": {k: kinds.count(k) for k in sorted(set(kinds))},
            "event_log": [e for e in server["events"] if e[0] != "staleness_exceeded"],
            "replicas": [{k: r.get(k) for k in ("exchanges", "steps_per_s", "wall_s",
                                                 "crashes", "rejoins", "restores",
                                                 "quarantines", "rejoin_steps_to_recover")}
                         for r in stats],
            "staleness": {r: {"n": len(v), "max": max(v), "mean": float(np.mean(v))}
                          for r, v in sorted(stale.items())},
            "step_straggler_rank": out.get("flight", {}).get("step_straggler_rank"),
            "losses_replica0": out["losses"], "eval_on_centre": out["eval"],
            "eval_at_init": initial_eval,
            # The gate PR 15's first tree had (replica 0's last two logged
            # losses against its first two), beside today's.
            "old_gate": {"first2_mean": head,
                         "last2_mean": float(np.mean(out["losses"][-2:])),
                         "passes": float(np.mean(out["losses"][-2:])) < head},
            "new_gate": {"first2_mean": head, "later_median": later,
                         "eval_loss": out["eval"]["loss"], "passes": ok},
            "every_replica": replicas,
            "replicas_with_jumps": sorted(r for r, v in replicas.items() if v["jumps"]),
            "kv_ship_launches": n, "fault_events": out.get("fault_events"),
        }
        print(json.dumps({"card": card, "elastic": {name: records[name]}}), flush=True)
    return {"launches": launches, "records": records}


def recovery_phases(torch, card, plans: dict) -> dict:
    """Phases 4k, 4kd, 4kx and 4e in turn, in a temporary directory
    deleted at the end; their records also go to
    ``chiprun_out/chip_smoke_recovery.json``. Returns the main paths'
    launches: the ring kernels' by run and kernel, the copy kernel's by
    run, the flash kernels' by run."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        t0 = time.perf_counter()
        resume = recovery_resume_phase(torch, card, plans, tmp)
        out["costs"] = recovery_save_timing(torch, card)
        print(f"phase 4k: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        out["divergence"] = recovery_divergence_phase(torch, card, tmp)
        print(f"phase 4kd: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        dense = recovery_dense_phase(torch, card, tmp)
        print(f"phase 4kx: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        elastic = elastic_phase(torch, card, tmp)
        print(f"phase 4e: {time.perf_counter() - t0:.1f} s", flush=True)
    out.update(resume=resume["records"], dense=dense["record"], elastic=elastic["records"])
    ring = {**resume["launches"],
            **{k: {n: c for n, c in v.items() if n.startswith("ring")}
               for k, v in dense["launches"].items()}}
    flash = {k: {n[len("flash_"):]: c for n, c in v.items() if n.startswith("flash_")}
             for k, v in dense["launches"].items()}
    launches = {"ring": ring, "kv_ship": elastic["launches"], "flash": flash}
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_recovery.json").write_text(json.dumps(
        {"card": card, "launches": launches, **out}, indent=1, default=str))
    return {"launches": launches}


# ---- speculative decoding and EASGD under SPMD (3s, 4s, 5s, 4z) ------------------

# 4s: phase 4's stream, drafting four tokens a tick with the target's
# first two layers; the verify runs the decode kernel at T = k + 1 = 5
# and the int8 matmul at 8 slots x 5 = 40 rows.
SPEC_K = 4
SPEC_ARGS = ["--spec-k", str(SPEC_K), "--draft-config", "truncate:2"]
SPEC_T = (2, 3, 4, 5)
SPEC_QMM_ROWS = B * (SPEC_K + 1)
# 5s: the widest gap at which f32 speculative greedy tokens may part
# from the plain engine's (the verify sums on the rows body at T = 5
# where a plain tick sums on split at T = 1: last-bit differences).
F32_TIE = 1e-3
# 4z: LeNet (configs #1-#2) for 30 steps of 32 images, and AlexNet
# (config #3) at full width for 8 steps over four ranks.
EASGD_MNIST_ARGS = ["--easgd", "true", "--steps", "30", "--batch-size", "32",
                    "--log-every", "1"]
EASGD_ALEXNET_STEPS = 8
# ring_q8's zero1 forms are held within 0.02 + 0.02·|loss| (the JAX
# package's q8 pin) over LeNet's first 20 steps, and both must end below
# 0.5. In the steep descent after them (steps 25-29: 1.2 -> 0.15) a
# rounding that falls the other way shifts the drop by a step, and the
# forms part by up to 0.09 on the CPU, as ring_q8 parts from psum there.
EASGD_Q8_PIN_STEPS = 20


def spec_kernel_phase(torch, flush) -> list:
    """Phase 3s: the decode kernel at the verify's query widths T = 2 to 5
    (dense and paged with pages of 16, bf16 over bf16 and over int8 K/V:
    the ``mma`` and ``q8mma`` bodies), S 512, lengths spread from 0 to S -
    T, against its plain version (bf16 tolerance) and SDPA on the same
    (gathered, dequantized) view; and the int8 matmul at the verify's 40
    rows on GPT-2 small's four shapes against its plain version and
    ``torch.matmul`` over the dequantized weight, the same bits on three
    repeated calls. Every case goes to ``chip_smoke_kernels.json``."""
    from mpit_tpu_torch.models.gpt2 import paged_gather
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.ops.kv_quant import dequantize_kv, kv_wire_bytes_per_row, quantize_kv

    cases, s, dtype = [], 512, torch.bfloat16
    gc.collect()
    warm_up(torch, 0.5)
    for int8 in (False, True):
        for ps in (None, 16):
            for t in SPEC_T:
                seed = 900 + t + (ps or 0) + 7 * int8
                gen = torch.Generator(device="cuda").manual_seed(seed)
                q = torch.randn((B, t, H, DH), generator=gen, device="cuda").to(dtype)
                lens = torch.linspace(0, s - t, B, device="cuda").int()
                if ps:
                    n_ps = s // ps
                    pool = B * n_ps + 1
                    k, v = (torch.randn((pool, ps, H, DH), generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                    perm = torch.randperm(pool, generator=torch.Generator().manual_seed(seed))
                    bt = perm[: B * n_ps].reshape(B, n_ps).int().cuda()
                    if int8:
                        k, v = quantize_kv(k), quantize_kv(v)
                    kd, vd = paged_gather(k, bt), paged_gather(v, bt)
                    form, extra = "flash_paged_decode_attention", bt.numel() * 4
                    run = lambda: da.flash_paged_decode_attention(q, k, v, lens, bt)  # noqa: E731
                    plain = lambda: da.reference_paged_decode_attention(q, k, v, lens, bt)  # noqa: E731
                else:
                    k, v = (torch.randn((B, s, H, DH), generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                    if int8:
                        k, v = quantize_kv(k), quantize_kv(v)
                    kd, vd = k, v
                    form, extra = "flash_decode_attention", 0
                    run = lambda: da.flash_decode_attention(q, k, v, lens)  # noqa: E731
                    plain = lambda: da.reference_decode_attention(q, k, v, lens)  # noqa: E731
                form += "_int8" if int8 else ""
                path = da._decode_path(dtype, torch.int8 if int8 else dtype, t)
                out = decode_call(torch, da, form, path, run)
                err = (out.float() - plain().float()).abs().max().item()
                if not math.isfinite(err) or err > TOL["bfloat16"]:
                    fail(f"3s {form} ps={ps} T={t}: kernel vs plain {err} > {TOL['bfloat16']}")
                if int8:
                    kd, vd = dequantize_kv(kd).to(dtype), dequantize_kv(vd).to(dtype)
                row = kv_wire_bytes_per_row(H, DH, torch.int8 if int8 else dtype)
                bound_ms, bound_by = bound(torch, lens, t, s, row, q, extra)
                cases.append({
                    "form": form, "path": path, "dtype": "bfloat16",
                    "kv": "int8" if int8 else "bfloat16", "page_size": ps, "B": B, "S": s,
                    "T": t, "H": H, "Dh": DH, "use": "verify", "max_abs_err": err,
                    "tol": TOL["bfloat16"], "ms": cold_time_ms(run, torch, flush),
                    "plain_ms": cold_time_ms(plain, torch, flush),
                    "library_ms": cold_time_ms(sdpa_call(torch, q, kd, vd, lens), torch, flush),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                })
                print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    m = SPEC_QMM_ROWS
    for d, f in QMM_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(m + d + f)
        x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
        w = qm.quantize_tensor(torch.randn((d, f), generator=gen, device="cuda") / math.sqrt(d))
        plan = qm.kernel_plan(m, d, f, dtype, x.device)
        paths = dict(qm.path_launches)
        out = qm.quantized_matmul(x, w)
        torch.cuda.synchronize()
        ran = {k: n - paths[k] for k, n in qm.path_launches.items() if n != paths[k]}
        if ran != {plan["path"]: 1}:
            fail(f"3s quantized_matmul M={m} D={d} F={f}: launches by body {ran}")
        plain = qm.quantized_matmul_plain(x, w)
        err = (out - plain).abs().max().item()
        tol = QMM_TOL * max(1.0, plain.abs().max().item())
        if not math.isfinite(err) or err > tol:
            fail(f"3s quantized_matmul M={m} D={d} F={f}: kernel vs plain {err} > {tol}")
        if not all(torch.equal(qm.quantized_matmul(x, w), out) for _ in range(3)):
            fail(f"3s quantized_matmul M={m} D={d} F={f}: repeated calls differ")
        w_deq = qm.dequantize_tensor(w)
        run = lambda: qm.quantized_matmul(x, w)  # noqa: E731
        bound_ms, bound_by = qmm_bound(m, d, f, x)
        cases.append({
            "form": "quantized_matmul", "dtype": "bfloat16", "M": m, "D": d, "F": f,
            "use": "verify", "path": plan["path"], "tile": list(plan["tile"]),
            "splits": plan["splits"], "blocks": plan["blocks"], "max_abs_err": err, "tol": tol,
            "ms": cold_time_ms(run, torch, flush),
            "plain_ms": cold_time_ms(lambda: qm.quantized_matmul_plain(x, w), torch, flush),
            "library_ms": cold_time_ms(lambda: torch.matmul(x.float(), w_deq), torch, flush),
            "device_ms": cold_time_ms(run, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
            "host_ms": host_time_ms(run, torch), "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    return cases


def spec_tick_profile(torch, args, ticks: int = 8) -> dict:
    """4s's dense speculative engine under ``torch.profiler``: ``ticks``
    speculative ticks (draft, then verify) of 8 slots after one prefill
    (see :func:`profile_window`)."""
    import numpy as np

    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.serve.__main__ import ServeConfig, _build_engine

    import numpy as np

    cfg = from_argv(ServeConfig, SERVE_ARGS + args)
    engine, mcfg = _build_engine(cfg)
    slots = cfg.slots
    tokens = np.random.default_rng(cfg.seed).integers(0, mcfg.vocab_size, (slots, cfg.prefill_len))
    every = np.ones(slots, bool)
    temp, topk = np.zeros(slots, np.float32), np.zeros(slots, np.int32)
    budget, eos = np.full(slots, 1 << 20, np.int32), np.full(slots, -1, np.int32)

    def tick(_):
        engine.spec_draft(every, temp, topk)
        engine.spec_verify(every, temp, topk, budget, eos)

    def start():
        engine.reset()
        engine.prefill(tokens, np.full(slots, cfg.prefill_len, np.int32), every, temp, topk)

    start()
    tick(None)  # the first launches' one-off costs, outside the window
    start()
    out = profile_window(torch, tick, list(range(ticks)))
    del engine
    torch.cuda.empty_cache()
    return out


def spec_serve_phase(torch, card, serve_records, tokens: dict) -> dict:
    """Phase 4s: phase 4's runs with ``--spec-k 4 --draft-config
    truncate:2`` through the serve CLI's ``main``: dense, paged, paged
    with int8 K/V and dense with int8 weights. Gates: 16 of 16 requests
    and 512 tokens; every attention launch on its form's tensor-core body
    (the prefill and the T = 5 verify; the target never decodes at T =
    1, the draft runs plain attention); with int8 weights every matmul
    launch on ``mma``; the greedy tokens against the plain run of the
    same form (:func:`server_tokens`), each parting judged by the plain
    path teacher-forced on the plain run's tokens: it fails where that
    path ranks the plain run's token above the speculative run's by more
    than ``INT8_TIE`` (the verify sums on the T = 5 tensor-core body where
    a plain tick sums on split: where the plain path ranks the
    speculative token higher, the plain run, not the speculative one,
    parted from it). Then a
    sampled run (temperature 1, top-k 50): its counts hold. Reports the
    acceptance, tokens per tick, decode tok/s beside phase 4's plain run
    and a profile of the dense speculative tick. Returns the launches by
    run and by body."""
    import dataclasses

    from mpit_tpu_torch.models import GPT2, GPT2Config
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.serve import quantize_gpt2_params
    from mpit_tpu_torch.serve.__main__ import main

    state = seeded_gpt2_state(torch, GPT2Config.small(), 0)
    judge = GPT2(GPT2Config.small(), device="cuda")
    judge.load_state_dict(state)
    judge_int8w = GPT2(
        dataclasses.replace(GPT2Config.small(), quant_matmul_fn=qm.quantized_matmul_reference),
        device="cuda", quantized=True,
    )
    judge_int8w.load_state_dict(quantize_gpt2_params(state))
    del state
    plain_tok_s = {tuple(r["args"]): r["serve"]["decode_tokens_per_sec"]
                   for r in serve_records if "serve" in r}
    runs = {
        "spec_dense": ([], FORMS[0]),
        "spec_paged": (PAGED_ARGS, FORMS[2]),
        "spec_paged_int8_kv": (PAGED_ARGS + ["--kv-dtype", "int8"], FORMS[3]),
        "spec_dense_int8_weights": (INT8W_ARGS, FORMS[0]),
        "spec_dense_sampled": (["--temperature", "1", "--top-k", "50"], FORMS[0]),
    }
    launches, bodies, qmm_launches, records = {}, {}, {}, []
    for name, (args, form) in runs.items():
        sampled = "--temperature" in args
        int8w = "--weights-dtype" in args
        if not sampled:
            want, prompts = server_tokens(torch, SERVE_ARGS + args, tokens)
        for mod in (da, qm):
            mod.launches.update(dict.fromkeys(mod.launches, 0))
            mod.path_launches.update(dict.fromkeys(mod.path_launches, 0))
        out = main(SERVE_ARGS + args + SPEC_ARGS)
        counts = dict(da.launches)
        paths = {k: n for k, n in da.path_launches.items() if n}
        mm, mm_paths = qm.launches["quantized_matmul"], {k: n for k, n in qm.path_launches.items() if n}
        phases = out["obs_summary"]
        layers = out["model"]["layers"]
        n_prefill, n_tick = phases["prefill"]["count"], phases["decode"]["count"]
        tag = f"4s {name}"
        if out["requests_completed"] != 16 or out["truncated"] or out["generated_tokens"] != 512:
            fail(f"{tag}: {out['requests_completed']} of 16 requests, "
                 f"{out['generated_tokens']} tokens of 512")
        body = "q8mma" if form.endswith("_int8") else "mma"
        want_paths = {f"{form}/{body}": layers * (n_prefill + n_tick)}
        if paths != want_paths or any(n for f, n in counts.items() if f != form):
            fail(f"{tag}: attention launches by body {paths}, expected {want_paths} "
                 f"(and no other form: {counts})")
        if phases["spec_verify"]["count"] != n_tick or phases["spec_draft"]["count"] != n_tick:
            fail(f"{tag}: {phases['spec_draft']['count']} drafts and "
                 f"{phases['spec_verify']['count']} verifies for {n_tick} ticks")
        # The target's four dense layers a call and the draft's (two
        # layers, k + 1 forwards a tick and one a prefill) on mma.
        need_mm = 4 * (layers * (n_prefill + n_tick) + 2 * (n_prefill + (SPEC_K + 1) * n_tick))
        if int8w and (mm != need_mm or mm_paths != {"mma": mm}):
            fail(f"{tag}: matmul launches {mm} by body {mm_paths}, expected {need_mm} on mma")
        if not int8w and mm:
            fail(f"{tag}: quantized_matmul launched without --weights-dtype int8")
        ties = None
        if not sampled:
            got, _ = server_tokens(torch, SERVE_ARGS + args + SPEC_ARGS, tokens)
            ties = fleet_divergences(torch, judge_int8w if int8w else judge, prompts, got, want,
                                     quantized="--kv-dtype" in args, what=tag, one_sided=True)
        launches[name] = counts[form]
        bodies[name] = paths
        qmm_launches[name] = mm
        records.append({
            "card": card, "run": name, "args": args + SPEC_ARGS,
            "requests_completed": out["requests_completed"],
            "generated_tokens": out["generated_tokens"], "ticks": n_tick,
            "accepted_tokens_per_tick": out["accepted_tokens_per_tick"],
            "draft_acceptance_rate": out["draft_acceptance_rate"],
            "decode_tokens_per_sec": out["decode_tokens_per_sec"],
            "plain_decode_tokens_per_sec": plain_tok_s.get(tuple(args)),
            "tick_ms_p50": phases["decode"]["p50_s"] * 1e3,
            "draft_ms_p50": phases["spec_draft"]["p50_s"] * 1e3,
            "verify_ms_p50": phases["spec_verify"]["p50_s"] * 1e3,
            "wall_s": out["wall_s"], "attention_launches_by_body": paths,
            "matmul_launches": mm,
            "tokens_vs_plain": None if ties is None else
            {"identical_requests": 16 - len(ties), "near_ties": ties},
        })
        print(json.dumps(records[-1]), flush=True)
    del judge, judge_int8w
    torch.cuda.empty_cache()
    records.append({"card": card, "spec_tick_profile": spec_tick_profile(torch, SPEC_ARGS)})
    print(json.dumps(records[-1]), flush=True)
    return {"launches": launches, "bodies": bodies, "qmm": qmm_launches, "records": records}


def spec_parity_phase(torch, mcfg, state) -> dict:
    """Phase 5s: f32 speculative greedy tokens at GPT-2 small's width
    (phase 5's weights and stream, k 4, the first two layers as the
    draft): the kernel engine (the verify on the decode kernel's rows
    body) and the reference engine against the plain kernel engine.
    Partings are judged by the plain model teacher-forced on the plain
    tokens, within ``F32_TIE``."""
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.serve import Engine, Server, draft_from_target
    from mpit_tpu_torch.serve.__main__ import ServeConfig, synthetic_requests

    cfg = from_argv(ServeConfig, SERVE_ARGS)
    dstate, dcfg = draft_from_target(state, mcfg, 2)
    tokens, prompts, stats = {}, {}, {}
    for name, mode, spec in (("plain", "kernel", {}),
                             ("spec_kernel", "kernel", dict(spec_k=SPEC_K, draft_params=dstate,
                                                            draft_cfg=dcfg)),
                             ("spec_reference", "reference", dict(
                                 spec_k=SPEC_K, draft_params=dstate, draft_cfg=dcfg))):
        engine = Engine(mcfg, state, slots=cfg.slots, max_len=cfg.max_len,
                        prefill_len=cfg.prefill_len, seed=cfg.seed, device="cuda",
                        decode_attention=mode, **spec)
        server = Server(engine)
        for req in synthetic_requests(cfg, mcfg.vocab_size):
            server.submit(req)
            prompts[str(req.rid)] = list(req.prompt)
        tokens[name] = {str(c.rid): list(c.tokens) for c in server.run()}
        stats[name] = {k: server.stats().get(k) for k in ("accepted_tokens_per_tick",
                                                          "draft_acceptance_rate", "ticks")}
        del engine, server
        torch.cuda.empty_cache()
    judge = GPT2(mcfg, device="cuda")
    judge.load_state_dict(state)
    out = {"stats": stats}
    for name in ("spec_kernel", "spec_reference"):
        got, want = tokens[name], tokens["plain"]
        if len(got) != 16 or sum(map(len, got.values())) != 512:
            fail(f"5s {name}: {len(got)} requests, {sum(map(len, got.values()))} tokens")
        ties = {}
        for r in want:
            if got[r] == want[r]:
                continue
            ties[r] = report_divergence(torch, judge, prompts[r], got[r], want[r])
            with torch.no_grad():
                i = ties[r]["token_index"]
                row = judge(torch.tensor([prompts[r] + want[r][:i]], device="cuda"))[0, -1]
            ties[r]["gap"] = (row[want[r][i]] - row[got[r][i]]).item()
        wide = {r: d for r, d in ties.items() if not abs(d["gap"]) <= F32_TIE}
        if wide:
            fail(f"5s {name}: f32 tokens part from the plain engine's beyond {F32_TIE}: {wide}")
        out[name] = {"identical_requests": 16 - len(ties), "near_ties": ties}
    del judge
    torch.cuda.empty_cache()
    print(json.dumps({"parity_spec_f32": out}), flush=True)
    return out


class capture_states:
    """For the enclosed block: every ``TrainState`` that
    ``runner.make_train_step``'s ``init_fn`` builds, in order (the CLI
    runs' states, which their steps update in place)."""

    def __init__(self):
        self.states = []

    def __enter__(self):
        from mpit_tpu_torch.asyncsgd import runner

        self.runner, self.orig = runner, runner.make_train_step

        def make_train_step(*a, **kw):
            init_fn, step_fn = self.orig(*a, **kw)

            def init(*ia, **ikw):
                state = init_fn(*ia, **ikw)
                self.states.append(state)
                return state

            return init, step_fn

        runner.make_train_step = make_train_step
        return self

    def __exit__(self, *exc):
        self.runner.make_train_step = self.orig


def flat_center(state):
    """A p-rank EASGD state's centre as one flat vector: the ZeRO-1
    ``[p, S]`` shards end to end, or rank 0's row of the plain-DP ``[p,
    N]`` centre."""
    (c,) = state.opt_state[1].center
    return c[0] if c.shape == state.flat.params.shape else c.reshape(-1)


def easgd_phase(torch, card, plans: dict) -> dict:
    """Phase 4z: EASGD under the SPMD step through the CLI (``--easgd
    true``): ``mnist`` on one rank, and over ``--mesh data=4`` through
    ``ring`` and ``ring_q8`` with ``--zero1`` true and false; AlexNet at
    full width over four ranks through ``ring`` for 8 steps. Gates:
    losses finite, LeNet's falling (the means of the first and last five;
    AlexNet's 8 steps are reported), the centre finite, the replicas
    bit-identical, the ring launches (set to 0 just before) buckets x
    steps of the mode's kinds, and the zero1 forms equal: ``ring``'s
    losses, parameters and centre bit for bit, ``ring_q8``'s losses
    within ``0.02 + 0.02·|loss|`` over ``EASGD_Q8_PIN_STEPS`` and both
    ending below 0.5 (the ZeRO-1 form gathers int8 updates where plain
    DP gathers int8 gradients). Returns the ring launches by run."""
    from mpit_tpu_torch.asyncsgd import imagenet, mnist
    from mpit_tpu_torch.ops import ring_collectives as rc

    runs = {"mnist_easgd_1": (mnist.main, "lenet", None, None, EASGD_MNIST_ARGS)}
    for mode in ("ring", "ring_q8"):
        for z in ("true", "false"):
            runs[f"mnist_easgd_{mode}_zero1_{z}"] = (
                mnist.main, "lenet", mode, z,
                EASGD_MNIST_ARGS + ["--mesh", f"data={CONV_RANKS}", "--grad-sync", mode,
                                    "--zero1", z])
    runs["imagenet_easgd_ring"] = (
        imagenet.main, "alexnet", "ring", "true",
        IMAGENET_ARGS + ["--easgd", "true", "--steps", str(EASGD_ALEXNET_STEPS), "--mesh",
                         f"data={CONV_RANKS}", "--grad-sync", "ring", "--zero1", "true"])
    import numpy as np

    launches, results, records = {}, {}, []
    for name, (main, net, mode, z, args) in runs.items():
        rc.launches.update(dict.fromkeys(rc.launches, 0))
        rc.path_launches.update(dict.fromkeys(rc.path_launches, 0))
        t0 = time.perf_counter()
        with capture_states() as cap:
            out = main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ring = {k: n for k, n in rc.launches.items() if n}
        (state,) = cap.states
        losses = out["losses"]
        steps = EASGD_ALEXNET_STEPS if net == "alexnet" else 30
        if out["steps"] != steps or not all(math.isfinite(x) for x in losses):
            fail(f"4z {name}: {out['steps']} steps, losses {losses}")
        first5, last5 = falling(losses)
        if net == "lenet" and not last5 < first5:
            fail(f"4z {name}: losses do not fall ({first5} -> {last5}): {losses}")
        center = flat_center(state) if mode else torch.cat(
            [t.reshape(-1) for t in state.opt_state[1].center.values()])
        if not bool(torch.isfinite(center).all()):
            fail(f"4z {name}: the centre is not finite")
        if mode and not out["replicas_identical"]:
            fail(f"4z {name}: the {CONV_RANKS} replicas differ")
        if mode:
            q = "_q8" if mode == "ring_q8" else ""
            want = {f"ring_rs{q}": plans[net]["buckets"] * steps,
                    f"ring_ag{q}": plans[net]["buckets"] * steps}
            if ring != want:
                fail(f"4z {name}: ring launches {ring}, expected {want}")
        elif ring:
            fail(f"4z {name}: ring launches on one rank: {ring}")
        launches[name] = ring
        results[name] = (losses, state)
        step_ms = np.asarray(out["step_ms"][2:])
        records.append({
            "card": card, "run": name, "args": args, "losses": losses,
            "first5_mean": first5, "last5_mean": last5, "eval": out.get("eval"),
            "step_ms_p50": float(np.percentile(step_ms, 50)), "wall_s": wall,
            "ring_launches": ring, "center_abs_max": float(center.abs().max()),
        })
        print(json.dumps({"easgd": records[-1]}), flush=True)
    forms = {}
    for mode in ("ring", "ring_q8"):
        (l1, s1), (l0, s0) = (results[f"mnist_easgd_{mode}_zero1_{z}"] for z in ("true", "false"))
        if mode == "ring":
            same = (l1 == l0 and torch.equal(s1.flat.params, s0.flat.params)
                    and torch.equal(flat_center(s1), flat_center(s0)))
            if not same:
                fail(f"4z {mode}: the zero1 forms differ: losses {l1} / {l0}")
        else:
            head = EASGD_Q8_PIN_STEPS
            gap = max(abs(a - b) - (0.02 + 0.02 * abs(b)) for a, b in zip(l1[:head], l0[:head]))
            if gap > 0 or not max(l1[-1], l0[-1]) < 0.5:
                fail(f"4z {mode}: the zero1 forms part beyond 0.02 + 0.02|loss| in the first "
                     f"{head} steps, or one ends above 0.5: {l1} / {l0}")
        forms[mode] = {"losses_equal": l1 == l0,
                       "center_max_abs_diff": float((flat_center(s1) - flat_center(s0))
                                                    .abs().max())}
    records.append({"card": card, "zero1_forms": forms})
    print(json.dumps({"easgd": records[-1]}), flush=True)
    del results
    torch.cuda.empty_cache()
    return {"launches": launches, "records": records}


def spec_phases(torch, card, flush, serve_records, mcfg, state, plans, tokens: dict) -> dict:
    """Phases 3s, 4s, 5s and 4z in turn; their records also go to
    ``chiprun_out/chip_smoke_spec.json``. ``tokens``: the plain runs'
    greedy tokens by CLI arguments, as 4f left them."""
    t0 = time.perf_counter()
    cases = spec_kernel_phase(torch, flush)
    print(f"phase 3s: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    serve = spec_serve_phase(torch, card, serve_records, tokens)
    print(f"phase 4s: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    parity = spec_parity_phase(torch, mcfg, state)
    print(f"phase 5s: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    easgd = easgd_phase(torch, card, plans)
    print(f"phase 4z: {time.perf_counter() - t0:.1f} s", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_spec.json").write_text(json.dumps(
        {"card": card, "cases": cases, "serve": serve["records"], "parity_f32": parity,
         "easgd": easgd["records"]}, indent=1, default=str))
    return {"cases": cases, "serve": serve, "easgd": easgd}


# Tensor-parallel serving (phases 3m, 4m, 5m): the model axis's ranks of
# GPT-2 small, all on the one card (``--mesh model=p``).
TP_P = (2, 4)
TP_T = (1, 2, 3, 4, SPEC_K + 1)  # the tick and the verify's widths; + prefill


def tp_qmm_shapes(p: int) -> dict:
    """Each dense layer's int8 shard (K, N) at ``p`` ranks: qkv and fc cut
    on their output columns, proj and out on their contraction rows."""
    return {"qkv": (768, 2304 // p), "fc": (768, 3072 // p), "proj": (768 // p, 768),
            "out": (3072 // p, 768)}


def tp_kernel_phase(torch, flush) -> list:
    """Phase 3m: the decode kernel on a TP rank's head shard of GPT-2 small
    (6 heads at p 2, 3 at p 4, Dh 64, 8 slots, S 512) in each form (dense,
    paged with pages of 16, each over bf16 or int8 K/V) at T 1 (split),
    2 to 5 (the verify) and the prefill width (128 dense, 64 paged), bf16
    q, against its plain version (5e-2) and, timed at T 1, 5 and the
    prefill width (``ms``, and ``device_ms`` without the wrapper's host
    time as in 3c), beside SDPA over the same shard and its bound; and
    the int8 matmul on every layer's shard at p 2 and 4
    (:func:`tp_qmm_shapes`) for M 8 (a tick), 40 (the verify) and 512 (a
    paged prefill chunk), bf16 x on ``mma``, against its plain version
    (1e-4 x max(1, max |plain|)) and ``torch.matmul`` over the
    dequantized shard."""
    from mpit_tpu_torch.models.gpt2 import paged_gather
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.ops.kv_quant import dequantize_kv, kv_wire_bytes_per_row, quantize_kv

    cases, s, dtype = [], 512, torch.bfloat16
    gc.collect()
    warm_up(torch, 0.5)
    for p in TP_P:
        h = H // p
        for form in FORMS:
            paged, int8 = "paged" in form, form.endswith("_int8")
            ps, width = (16, 64) if paged else (None, 128)
            for t in TP_T + (width,):
                seed = 1700 + 10 * p + t + 3 * int8 + 5 * paged
                gen = torch.Generator(device="cuda").manual_seed(seed)
                q = torch.randn((B, t, h, DH), generator=gen, device="cuda").to(dtype)
                lens = torch.linspace(0, s - t, B, device="cuda").int()
                if paged:
                    n_ps = s // ps
                    pool = B * n_ps + 1
                    k, v = (torch.randn((pool, ps, h, DH), generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                    perm = torch.randperm(pool, generator=torch.Generator().manual_seed(seed))
                    bt = perm[: B * n_ps].reshape(B, n_ps).int().cuda()
                    if int8:
                        k, v = quantize_kv(k), quantize_kv(v)
                    kd, vd, extra = paged_gather(k, bt), paged_gather(v, bt), bt.numel() * 4
                    run = lambda: da.flash_paged_decode_attention(q, k, v, lens, bt)  # noqa: E731
                    plain = lambda: da.reference_paged_decode_attention(q, k, v, lens, bt)  # noqa: E731
                else:
                    k, v = (torch.randn((B, s, h, DH), generator=gen, device="cuda").to(dtype)
                            for _ in range(2))
                    if int8:
                        k, v = quantize_kv(k), quantize_kv(v)
                    kd, vd, extra = k, v, 0
                    run = lambda: da.flash_decode_attention(q, k, v, lens)  # noqa: E731
                    plain = lambda: da.reference_decode_attention(q, k, v, lens)  # noqa: E731
                path = da._decode_path(dtype, torch.int8 if int8 else dtype, t)
                out = decode_call(torch, da, form, path, run)
                err = (out.float() - plain().float()).abs().max().item()
                if not math.isfinite(err) or err > TOL["bfloat16"]:
                    fail(f"3m {form} p={p} H={h} T={t}: kernel vs plain {err} > {TOL['bfloat16']}")
                case = {"form": form, "path": path, "p": p, "dtype": "bfloat16",
                        "kv": "int8" if int8 else "bfloat16", "page_size": ps, "B": B, "S": s,
                        "T": t, "H": h, "Dh": DH, "max_abs_err": err, "tol": TOL["bfloat16"]}
                if t in (1, SPEC_K + 1, width):
                    if int8:
                        kd, vd = dequantize_kv(kd).to(dtype), dequantize_kv(vd).to(dtype)
                    row = kv_wire_bytes_per_row(h, DH, torch.int8 if int8 else dtype)
                    bound_ms, bound_by = bound(torch, lens, t, s, row, q, extra)
                    case.update(
                        ms=cold_time_ms(run, torch, flush),
                        device_ms=cold_time_ms(run, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
                        plain_ms=cold_time_ms(plain, torch, flush),
                        library_ms=cold_time_ms(sdpa_call(torch, q, kd, vd, lens), torch, flush),
                        bound_ms=bound_ms, bound_by=bound_by)
                cases.append(case)
                print(json.dumps({"kernel_case": case}), flush=True)
    for p in TP_P:
        for layer, (d, f) in tp_qmm_shapes(p).items():
            for m in (B, SPEC_QMM_ROWS, 512):
                gen = torch.Generator(device="cuda").manual_seed(2000 + m + d + f)
                x = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
                w = qm.quantize_tensor(torch.randn((d, f), generator=gen, device="cuda")
                                       / math.sqrt(d))
                plan = qm.kernel_plan(m, d, f, dtype, x.device)
                paths = dict(qm.path_launches)
                out = qm.quantized_matmul(x, w)
                torch.cuda.synchronize()
                ran = {k: n - paths[k] for k, n in qm.path_launches.items() if n != paths[k]}
                if ran != {"mma": 1} or plan["path"] != "mma":
                    fail(f"3m quantized_matmul p={p} {layer} M={m}: launches by body {ran}")
                plain = qm.quantized_matmul_plain(x, w)
                err = (out - plain).abs().max().item()
                tol = QMM_TOL * max(1.0, plain.abs().max().item())
                if not math.isfinite(err) or err > tol:
                    fail(f"3m quantized_matmul p={p} {layer} M={m} D={d} F={f}: "
                         f"kernel vs plain {err} > {tol}")
                w_deq = qm.dequantize_tensor(w)  # the yardstick's, not timed
                run = lambda: qm.quantized_matmul(x, w)  # noqa: E731
                bound_ms, bound_by = qmm_bound(m, d, f, x)
                cases.append({
                    "form": "quantized_matmul", "p": p, "layer": layer, "dtype": "bfloat16",
                    "M": m, "D": d, "F": f, "path": plan["path"], "tile": list(plan["tile"]),
                    "splits": plan["splits"], "blocks": plan["blocks"], "max_abs_err": err,
                    "tol": tol, "ms": cold_time_ms(run, torch, flush),
                    "device_ms": cold_time_ms(run, torch, flush, lead_cycles=HOST_LEAD_CYCLES),
                    "plain_ms": cold_time_ms(lambda: qm.quantized_matmul_plain(x, w), torch,
                                             flush),
                    "library_ms": cold_time_ms(lambda: torch.matmul(x.float(), w_deq), torch,
                                               flush),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                })
                print(json.dumps({"kernel_case": cases[-1]}), flush=True)
    return cases


class served_tokens:
    """For the enclosed block: the tokens of the last ``Server.run`` (the
    serve CLI's ``main`` builds its own Server), by request id."""

    def __enter__(self):
        import mpit_tpu_torch.serve as serve

        self.serve, self.cls, probe = serve, serve.Server, self
        self.tokens = None

        class Recording(serve.Server):
            def run(self, *a, **kw):
                done = super().run(*a, **kw)
                probe.tokens = {str(c.rid): list(c.tokens) for c in done}
                return done

        serve.Server = Recording
        return self

    def __exit__(self, *exc):
        self.serve.Server = self.cls


def tp_tick_profile(torch, p: int, ticks: int = 8) -> dict:
    """Eight decode ticks of phase 4's dense bf16 engine over ``p`` ranks
    (1: the one-rank engine) under ``torch.profiler``, after one prefill
    of every slot and one untimed tick (see :func:`profile_window`)."""
    import numpy as np

    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.serve.__main__ import ServeConfig, _build_engine

    cfg = from_argv(ServeConfig, SERVE_ARGS + ([] if p == 1 else ["--mesh", f"model={p}"]))
    engine, mcfg = _build_engine(cfg)
    slots = cfg.slots
    tokens = np.random.default_rng(cfg.seed).integers(0, mcfg.vocab_size, (slots, cfg.prefill_len))
    every = np.ones(slots, bool)
    temp, topk = np.zeros(slots, np.float32), np.zeros(slots, np.int32)
    engine.prefill(tokens, np.full(slots, cfg.prefill_len, np.int32), every, temp, topk)
    engine.decode(every, temp, topk)  # the first launches' one-off costs
    out = profile_window(torch, lambda _: engine.decode(every, temp, topk), list(range(ticks)))
    del engine
    torch.cuda.empty_cache()
    return out


def tp_serve_phase(torch, card, tokens: dict, one_rank_ticks: dict) -> dict:
    """Phase 4m: ``python -m mpit_tpu_torch.serve --mesh model=p``'s
    ``main`` at phase 4's configuration, p 2 and 4: dense, paged, paged
    int8 K/V and dense int8 weights, and at p 2 one speculative run
    (``--spec-k 4 --draft-config truncate:2``, the draft replicated).
    Gates: 16 of 16 requests and 512 tokens; attention launches p x
    layers a call, by body exactly as phase 4 (4s for the speculative
    run) counts them; with int8 weights exactly 4 x p x layers matmul
    launches a call, all on ``mma``; greedy tokens against phase 4's
    one-rank run of the same form (:func:`server_tokens`), each parting
    judged by the plain path teacher-forced on the one-rank tokens, one-
    sided as in 4s: it fails where that path ranks the one-rank token
    above the TP run's by more than ``BF16_TIE`` (bf16 partials are
    rounded per rank before the sum; where the plain path ranks the TP
    token higher, the one-rank run, not the TP run, parted from it: seen
    at the prefill's first token, gap -0.0108).
    Records tick p50 beside the one-rank run's of the same call (phase
    4's, ``one_rank_ticks`` by args; none when 4m runs alone), launches a
    tick by kernel and, for the dense engine at p 1, 2 and 4, a profile
    of eight ticks (device time a tick by family, idle share). Returns
    the launches by run and body."""
    import dataclasses

    from mpit_tpu_torch.models import GPT2, GPT2Config
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.serve import quantize_gpt2_params
    from mpit_tpu_torch.serve.__main__ import main

    state = seeded_gpt2_state(torch, GPT2Config.small(), 0)
    judge = GPT2(GPT2Config.small(), device="cuda")
    judge.load_state_dict(state)
    judge_int8w = GPT2(
        dataclasses.replace(GPT2Config.small(), quant_matmul_fn=qm.quantized_matmul_reference),
        device="cuda", quantized=True,
    )
    judge_int8w.load_state_dict(quantize_gpt2_params(state))
    del state
    forms = {"dense": ([], FORMS[0]), "paged": (PAGED_ARGS, FORMS[2]),
             "paged_int8_kv": (PAGED_ARGS + ["--kv-dtype", "int8"], FORMS[3]),
             "dense_int8_weights": (INT8W_ARGS, FORMS[0])}
    # Each run: (the one-rank run's args, the run's args, form, p, speculative).
    runs = {f"tp{p}_{name}": (args, args, form, p, False)
            for p in TP_P for name, (args, form) in forms.items()}
    runs["tp2_spec_dense"] = ([], SPEC_ARGS, FORMS[0], 2, True)
    bodies, qmm_launches, records = {}, {}, []
    for name, (base, args, form, p, spec) in runs.items():
        want, prompts = server_tokens(torch, SERVE_ARGS + base, tokens)
        int8w = "--weights-dtype" in args
        for mod in (da, qm):
            mod.launches.update(dict.fromkeys(mod.launches, 0))
            mod.path_launches.update(dict.fromkeys(mod.path_launches, 0))
        with served_tokens() as served:
            out = main(SERVE_ARGS + args + ["--mesh", f"model={p}"])
        counts = dict(da.launches)
        paths = {k: n for k, n in da.path_launches.items() if n}
        mm, mm_paths = qm.launches["quantized_matmul"], {k: n for k, n in qm.path_launches.items() if n}
        phases = out["obs_summary"]
        layers = out["model"]["layers"]
        n_prefill, n_tick = phases["prefill"]["count"], phases["decode"]["count"]
        tag = f"4m {name}"
        if out["requests_completed"] != 16 or out["truncated"] or out["generated_tokens"] != 512:
            fail(f"{tag}: {out['requests_completed']} of 16 requests, "
                 f"{out['generated_tokens']} tokens of 512")
        if out["tensor_parallel"] != p or out["device"] != "cuda" \
                or out["decode_attention"] != "kernel":
            fail(f"{tag}: served tp={out['tensor_parallel']} on {out['device']} "
                 f"({out['decode_attention']})")
        pre = "q8mma" if form.endswith("_int8") else "mma"
        want_paths = ({f"{form}/mma": p * layers * (n_prefill + n_tick)} if spec else
                      {f"{form}/{pre}": p * layers * n_prefill,
                       f"{form}/split": p * layers * n_tick})
        if paths != want_paths or any(n for f, n in counts.items() if f != form):
            fail(f"{tag}: attention launches by body {paths}, expected {want_paths} "
                 f"(and no other form: {counts})")
        need_mm = 4 * p * layers * (n_prefill + n_tick) if int8w else 0
        if mm != need_mm or (mm and mm_paths != {"mma": mm}):
            fail(f"{tag}: matmul launches {mm} by body {mm_paths}, expected {need_mm} on mma")
        ties = fleet_divergences(torch, judge_int8w if int8w else judge, prompts, served.tokens,
                                 want, quantized="--kv-dtype" in args, what=tag, one_sided=True,
                                 tie=BF16_TIE)
        bodies[name] = paths
        qmm_launches[name] = mm
        calls = n_prefill + n_tick
        records.append({
            "card": card, "run": name, "p": p, "args": args + ["--mesh", f"model={p}"],
            "requests_completed": out["requests_completed"],
            "generated_tokens": out["generated_tokens"], "prefill_calls": n_prefill,
            "ticks": n_tick, "decode_tokens_per_sec": out["decode_tokens_per_sec"],
            "tick_ms_p50": phases["decode"]["p50_s"] * 1e3,
            "tick_ms_p95": phases["decode"]["p95_s"] * 1e3,
            "one_rank_tick_ms_p50": one_rank_ticks.get(tuple(args)),
            "prefill_ms_p50": phases["prefill"]["p50_s"] * 1e3,
            "wall_s": out["wall_s"], "attention_launches_by_body": paths,
            "matmul_launches": mm,
            "launches_per_tick": {
                "decode_attention": (paths.get(f"{form}/split", 0) / n_tick) if not spec
                else paths.get(f"{form}/mma", 0) / calls,
                "quantized_matmul": mm / calls},
            "tokens_vs_one_rank": {"identical_requests": 16 - len(ties), "near_ties": ties},
        })
        if spec:
            records[-1].update({k: out.get(k) for k in ("accepted_tokens_per_tick",
                                                          "draft_acceptance_rate")})
        print(json.dumps(records[-1]), flush=True)
    del judge, judge_int8w
    torch.cuda.empty_cache()
    profiles = {f"p{p}": tp_tick_profile(torch, p) for p in (1,) + TP_P}
    records.append({"card": card, "tp_tick_profile_dense_bf16": profiles})
    print(json.dumps(records[-1]), flush=True)
    return {"bodies": bodies, "qmm": qmm_launches, "records": records}


def tp_parity_phase(torch, mcfg, state, one_rank: dict) -> dict:
    """Phase 5m: f32 greedy tokens at GPT-2 small's width (phase 5's
    weights and stream) of the TP kernel engine at p 2 and 4 and the TP
    reference engine at p 2: each 16 of 16 requests identical to phase
    5's one-rank kernel engine's (``one_rank``), or the phase fails with
    the first parting and the one-rank model's margin there."""
    from mpit_tpu_torch import comm
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.models import GPT2
    from mpit_tpu_torch.serve import Engine, Server
    from mpit_tpu_torch.serve.__main__ import ServeConfig, synthetic_requests

    cfg = from_argv(ServeConfig, SERVE_ARGS)
    out, prompts = {}, {}
    for name, mode, p in (("kernel_tp2", "kernel", 2), ("kernel_tp4", "kernel", 4),
                          ("reference_tp2", "reference", 2)):
        engine = Engine(mcfg, state, slots=cfg.slots, max_len=cfg.max_len,
                        prefill_len=cfg.prefill_len, seed=cfg.seed, device="cuda",
                        decode_attention=mode, tp_axis="model",
                        world=comm.init({"model": p}, devices=["cuda"]))
        server = Server(engine)
        for req in synthetic_requests(cfg, mcfg.vocab_size):
            server.submit(req)
            prompts[req.rid] = list(req.prompt)
        got = {c.rid: c.tokens for c in server.run()}
        del engine, server
        torch.cuda.empty_cache()
        diff = sorted(r for r in one_rank if got.get(r) != one_rank[r])
        if len(got) != 16 or diff:
            judge = GPT2(mcfg, device="cuda")
            judge.load_state_dict(state)
            fail(f"5m {name}: f32 TP tokens differ from the one-rank engine's for {diff}: "
                 + "; ".join(str(report_divergence(torch, judge, prompts[r], got[r], one_rank[r]))
                             for r in diff[:3]))
        out[name] = {"identical_requests": 16, "tokens": sum(map(len, got.values()))}
    print(json.dumps({"parity_tp_f32": out}), flush=True)
    return out


def tp_phases(torch, card, flush, mcfg, state, one_rank: dict, tokens: dict,
              serve_records=()) -> dict:
    """Phases 3m, 4m and 5m in turn; their records go to
    ``chiprun_out/chip_smoke_tp.json``. ``serve_records``: phase 4's and
    4s's, for the one-rank tick p50 of each form."""
    ticks = {tuple(r["args"]): r["decode_tick_ms_p50"] for r in serve_records if "serve" in r}
    t0 = time.perf_counter()
    cases = tp_kernel_phase(torch, flush)
    t1 = time.perf_counter()
    serve = tp_serve_phase(torch, card, tokens, ticks)
    t2 = time.perf_counter()
    parity = tp_parity_phase(torch, mcfg, state, one_rank)
    t3 = time.perf_counter()
    seconds = {"3m": t1 - t0, "4m": t2 - t1, "5m": t3 - t2}
    print(f"phases 3m, 4m, 5m: {seconds}", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_tp.json").write_text(json.dumps(
        {"card": card, "seconds": seconds, "cases": cases, "serve": serve["records"],
         "parity_tp_f32": parity}, indent=1, default=str))
    return {"cases": cases, "serve": serve}


def tp_kernel_rows(tp: dict) -> list:
    """The kernels line's rows of phases 3m and 4m: each decode form phase
    4m drives at each p, at T 1 (its split body, with the tick launches)
    and at its prefill width (with the prefill launches); the dense form
    at the verify's T 5 with the speculative run's launches; and the int8
    matmul on each layer's shard at M 8 with its share of the int8-weight
    run's launches (the gate holds them equal over the four layers)."""
    rows = []
    runs = {FORMS[0]: "dense", FORMS[2]: "paged", FORMS[3]: "paged_int8_kv"}
    for p in TP_P:
        for form, run in runs.items():
            width = 64 if "paged" in form else 128
            for t, suffix in ((1, ""), (width, "_prefill")):
                head = next(c for c in tp["cases"] if c["form"] == form and c["p"] == p
                            and c["T"] == t)
                rows.append({
                    "name": f"{form}_tp{p}{suffix}", "route": "cuda", "path": head["path"],
                    "source": "mpit_tpu_torch/csrc/decode_attention.cu",
                    "replaces": "mpit_tpu/ops/decode_attention.py:166",
                    "call_site": ("mpit_tpu/ops/decode_attention.py:419" if "paged" in form
                                  else "mpit_tpu/ops/decode_attention.py:369"),
                    "launches": tp["serve"]["bodies"][f"tp{p}_{run}"].get(
                        f"{form}/{head['path']}", 0),
                    **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
                    "shape": {k: head.get(k) for k in ("dtype", "kv", "page_size", "B", "S", "T",
                                                       "H", "Dh")},
                })
    head = next(c for c in tp["cases"] if c["form"] == FORMS[0] and c["p"] == 2
                and c["T"] == SPEC_K + 1)
    rows.append({
        "name": f"{FORMS[0]}_tp2_verify", "route": "cuda", "path": head["path"],
        "source": "mpit_tpu_torch/csrc/decode_attention.cu",
        "replaces": "mpit_tpu/ops/decode_attention.py:166",
        "call_site": "mpit_tpu/ops/decode_attention.py:369",
        "launches": tp["serve"]["bodies"]["tp2_spec_dense"].get(f"{FORMS[0]}/mma", 0),
        **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "shape": {k: head.get(k) for k in ("dtype", "kv", "page_size", "B", "S", "T", "H",
                                           "Dh")},
    })
    for p in TP_P:
        for layer in tp_qmm_shapes(p):
            head = next(c for c in tp["cases"] if c["form"] == "quantized_matmul"
                        and c["p"] == p and c["layer"] == layer and c["M"] == B)
            rows.append({
                "name": f"quantized_matmul_tp{p}_{layer}", "route": "cuda", "path": head["path"],
                "source": "mpit_tpu_torch/csrc/quantized_matmul.cu",
                "replaces": "mpit_tpu/ops/quantized_matmul.py:272",
                "call_site": "mpit_tpu/ops/quantized_matmul.py:321",
                "launches": tp["serve"]["qmm"][f"tp{p}_dense_int8_weights"] // 4,
                **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "splits", "blocks")},
                "shape": {k: head[k] for k in ("dtype", "M", "D", "F")},
            })
    return rows

# Phase 4p: open-loop serving under the scheduling policy, at a capacity
# that makes it preempt. GPT-2 small at phase 4's width, 4 slots over 96
# pages of 16 tokens (four batch requests of up to 18 pages fit, so the
# slots bind), prefill chunk 64; interactive requests (priority 0, a 20 ms
# TTFT target: any queued one that finds no free slot is projected past
# it) and batch requests (priority 1, long outputs), seeded, 6 req/s for
# 4 s, drained.
POLICY_ARGS = ["--slots", "4", "--kv-pages", "96", "--kv-page-size", "16",
               "--prefill-chunk", "64"]
POLICY_HOST = ["--kv-host-pages", "160"]
POLICY_SPEC = "admission=0,min_samples=2"
POLICY_RATE, POLICY_DURATION, POLICY_TTFT = 8.0, 4.0, 0.02
POLICY_CLI_LOAD = ("rate=4,prompt_min=16,prompt_max=64,new_min=16,new_max=32,"
                   "priority=1,ttft_target=0.5")
POLICY_SPILL_PAGES = 32  # pages a spill/restore timing moves


def policy_load(loadgen):
    classes = (
        loadgen.RequestClass("interactive", weight=0.5, prompt_len=(8, 48),
                             max_new_tokens=(8, 16), priority=0, ttft_target_s=POLICY_TTFT),
        loadgen.RequestClass("batch", weight=0.5, prompt_len=(64, 128),
                             max_new_tokens=(96, 160), priority=1),
    )
    return loadgen.LoadSpec(rate=POLICY_RATE, classes=classes)


class PageCheck:
    """Wraps one engine's host-tier calls: each spilled page's tensors are
    cloned on the card as the spill starts (stream order puts the clone
    where the spill's gather reads), and after each restore the page must
    equal that clone bit for bit."""

    def __init__(self, torch, engine):
        self.torch, self.engine = torch, engine
        self.saved, self.checked, self.bad = {}, 0, []
        self._spill, self._restore, self._free = (
            engine.spill_page, engine.restore_page, engine.host_free)
        engine.spill_page, engine.restore_page, engine.host_free = (
            self.spill, self.restore, self.free)

    def spill(self, dp, hp, **ledger):
        self.saved[int(hp)] = [v.clone() for v in self.engine._page_views(int(dp))]
        self._spill(dp, hp, **ledger)

    def restore(self, hp, dp, *, release=False, **ledger):
        self._restore(hp, dp, release=release, **ledger)
        want = self.saved.pop(int(hp)) if release else self.saved[int(hp)]
        got = self.engine._page_views(int(dp))
        self.checked += 1
        if not all(self.torch.equal(a, b) for a, b in zip(got, want)):
            self.bad.append((int(hp), int(dp)))

    def free(self, hp, **ledger):
        self.saved.pop(int(hp), None)
        self._free(hp, **ledger)


def tier_copy_ms(torch, engine) -> dict:
    """Spill and restore times a page on an idle engine: POLICY_SPILL_PAGES
    spills then one drain, and as many restores then a synchronize, each
    on the wall clock after one untimed round; the page's bytes beside."""
    n = POLICY_SPILL_PAGES
    out = {"page_bytes": engine.page_bytes}
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            engine.spill_page(i, i)
        engine.drain_spills()
        t1 = time.perf_counter()
        for i in range(n):
            engine.restore_page(i, n + i, release=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    out["spill_ms_a_page"] = (t1 - t0) * 1e3 / n
    out["restore_ms_a_page"] = (t2 - t1) * 1e3 / n
    out["spill_gb_per_s"] = engine.page_bytes * n / (t1 - t0) / 1e9
    out["restore_gb_per_s"] = engine.page_bytes * n / (t2 - t1) / 1e9
    engine.reset()
    return out


def policy_cli_run(torch, card) -> dict:
    """The CLI's open-loop path once: ``--loadgen`` with ``--policy`` and
    ``--kv-host-pages`` on the paged pool, every arrival answered through
    the paged form's bodies."""
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.serve.__main__ import main

    da.launches.update(dict.fromkeys(da.launches, 0))
    da.path_launches.update(dict.fromkeys(da.path_launches, 0))
    out = main(SERVE_ARGS + POLICY_ARGS + POLICY_HOST + [
        "--loadgen", POLICY_CLI_LOAD, "--duration", "2", "--policy", POLICY_SPEC,
        "--stats-interval", "1"])
    paths = {k: n for k, n in da.path_launches.items() if n}
    if out["requests_completed"] != out["load"]["arrivals"] or out["truncated"]:
        fail(f"4p CLI: {out['requests_completed']} of {out['load']['arrivals']} answered")
    if set(paths) != {f"{FORMS[2]}/split", f"{FORMS[2]}/mma"} or out["device"] != "cuda":
        fail(f"4p CLI: launches by body {paths} on {out['device']}")
    return {"card": card, "args": POLICY_ARGS + POLICY_HOST, "load": out["load"],
            "requests_completed": out["requests_completed"], "wall_s": out["wall_s"],
            "ttft_p95_s": out.get("ttft_p95_s"), "policy": out["policy"],
            "launches_by_body": paths}


def policy_run(torch, card, name, args, form, judge, f32_state=None) -> dict:
    """One 4p run: the engine the CLI builds for ``args`` (with
    ``f32_state``, the same engine over GPT-2 small in f32 with those
    weights), warmed, then ``Server.run_timed`` over the seeded two-class
    trace under the policy, drained, every restore checked against its
    spill; then the preempted requests closed loop (FIFO, no policy) on
    the same engine, their tokens held against the open-loop run's (one
    sided, the plain path teacher-forced: within ``BF16_TIE`` in bf16,
    ``F32_TIE`` in f32)."""
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.models import GPT2Config
    from mpit_tpu_torch.obs.stream import StreamRegistry
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.serve import (
        Engine, Request, SchedulingPolicy, Server, generate_arrivals, loadgen,
        parse_policy_spec, warm_engine,
    )
    from mpit_tpu_torch.serve.__main__ import ServeConfig, _build_engine

    import numpy as np

    cfg = from_argv(ServeConfig, SERVE_ARGS + args)
    if f32_state is None:
        engine, mcfg = _build_engine(cfg)
    else:
        mcfg = GPT2Config.small(dtype=torch.float32)
        engine = Engine(
            mcfg, f32_state, slots=cfg.slots, max_len=cfg.max_len, prefill_len=cfg.prefill_len,
            seed=cfg.seed, device="cuda", kv_pages=cfg.kv_pages,
            kv_page_size=cfg.kv_page_size, prefill_chunk=cfg.prefill_chunk,
            kv_dtype=cfg.kv_dtype or None, weights_dtype=cfg.weights_dtype or None,
            kv_host_pages=cfg.kv_host_pages or None,
        )
    host = engine.host_pages > 0
    warm_engine(engine)
    copy = tier_copy_ms(torch, engine) if host else None
    check = PageCheck(torch, engine) if host else None
    arrivals = generate_arrivals(policy_load(loadgen), vocab_size=mcfg.vocab_size,
                                 duration_s=POLICY_DURATION, seed=0)
    registry = StreamRegistry()
    server = Server(engine, stream=registry,
                    policy=SchedulingPolicy(parse_policy_spec(POLICY_SPEC), registry))
    for mod in (da, qm):
        mod.launches.update(dict.fromkeys(mod.launches, 0))
        mod.path_launches.update(dict.fromkeys(mod.path_launches, 0))
    victims = set()
    preempt = server._preempt

    def note(slot, **kw):
        victims.add(server.live[slot].req.rid)
        preempt(slot, **kw)

    server._preempt = note
    t0 = time.perf_counter()
    done = server.run_timed(arrivals, duration=POLICY_DURATION, drain=True)
    wall = time.perf_counter() - t0
    st = server.stats()
    paths = {k: n for k, n in da.path_launches.items() if n}
    qmm = qm.launches["quantized_matmul"]
    qmm_paths = {k: n for k, n in qm.path_launches.items() if n}
    tag = f"4p {name}"
    got = {c.rid: list(c.tokens) for c in done}
    want_n = {a.request.rid: a.request.max_new_tokens for a in arrivals}
    if {r: len(t) for r, t in got.items()} != want_n or st["truncated"] or st["shed"]:
        fail(f"{tag}: {len(got)} of {len(arrivals)} arrivals answered in full "
             f"(shed {st['shed']}, truncated {st['truncated']})")
    resumes = {m: len(d) for m, d in server.resume_durations.items()}
    mode = "restream" if host else "recompute"
    if not st["preemptions"] or not resumes[mode] or (host and not st["host_restreamed_pages"]):
        fail(f"{tag}: preemptions {st['preemptions']}, resumes {resumes}, restreamed "
             f"pages {st.get('host_restreamed_pages')}")
    if check is not None and (check.bad or not check.checked):
        fail(f"{tag}: restored pages differ from their spills at (seat, page) {check.bad} "
             f"of {check.checked}")
    bf16 = f32_state is None
    body = "q8mma" if form.endswith("_int8") else "mma" if bf16 else "rows"
    if set(paths) != {f"{form}/split", f"{form}/{body}"}:
        fail(f"{tag}: attention launches by body {paths}")
    int8w = "--weights-dtype" in args
    if int8w != bool(qmm) or (int8w and qmm_paths != {"mma" if bf16 else "fma": qmm}):
        fail(f"{tag}: quantized_matmul launches {qmm} by body {qmm_paths}")
    # The preempted requests' closed-loop run on the same engine.
    engine.reset()
    if check is not None:
        engine.spill_page, engine.restore_page, engine.host_free = (
            check._spill, check._restore, check._free)
    by_rid = {a.request.rid: a.request for a in arrivals}
    closed = Server(engine)
    for rid in sorted(victims):
        r = by_rid[rid]
        closed.submit(Request(rid=rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    want = {c.rid: list(c.tokens) for c in closed.run()}
    ties = fleet_divergences(torch, judge, {r: by_rid[r].prompt for r in want},
                             {r: got[r] for r in want}, want, quantized="--kv-dtype" in args,
                             what=tag, one_sided=True, tie=BF16_TIE if bf16 else F32_TIE)
    durs = {m: d for m, d in server.resume_durations.items() if d}
    rec = {
        "card": card, "run": name, "args": args, "dtype": "bf16" if bf16 else "f32",
        "wall_s": wall,
        "arrivals": len(arrivals), "requests_completed": len(done),
        "generated_tokens": st["generated_tokens"], "ticks": st["ticks"],
        "preemptions": st["preemptions"], "policy": st["policy"], "resumes": resumes,
        "resume_ms": {m: {"p50": float(np.percentile(d, 50)) * 1e3,
                          "p95": float(np.percentile(d, 95)) * 1e3, "n": len(d)}
                      for m, d in durs.items()},
        "ttft_ms_by_tier": {
            t: {"p50": registry.total_sketch(f"request_ttft_tier{t}").quantile(0.5) * 1e3,
                "p95": registry.total_sketch(f"request_ttft_tier{t}").quantile(0.95) * 1e3}
            for t in (0, 1) if registry.total_sketch(f"request_ttft_tier{t}") is not None},
        "kv_pool_occupancy_peak": st["kv_pool_occupancy_peak"],
        "concurrency_peak": st["concurrency_peak"],
        "attention_launches_by_body": paths, "matmul_launches": qmm,
        "matmul_launches_by_body": qmm_paths,
        "preempted_requests": len(victims),
        "tokens_vs_closed_loop": {"identical_requests": len(victims) - len(ties),
                                  "near_ties": ties},
    }
    if host:
        rec.update({k: st[k] for k in (
            "host_spilled_pages", "host_restreamed_pages", "host_spill_bytes",
            "host_restream_bytes", "host_held_peak_bytes", "parked_spills",
            "spilled_prefix_entries", "host_prefix_hits", "promoted_entries")})
        rec["restores_checked_bit_equal"] = check.checked
        rec["tier_copy"] = copy
    print(json.dumps(rec), flush=True)
    del engine, server, closed
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def policy_phase(torch, card) -> dict:
    """Phase 4p: the CLI's open-loop path once, then the bf16 and int8 K/V
    pools with the host tier and the int8-weight pool without one, then
    that int8-weight run in f32; its records go to
    ``chiprun_out/chip_smoke_policy.json``. Returns the bf16 runs'
    attention and matmul launches by body (the f32 run's are in its
    record: a parity check, not the bf16 rows of the kernels line)."""
    import dataclasses

    from mpit_tpu_torch.models import GPT2, GPT2Config
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.serve import quantize_gpt2_params

    t0 = time.perf_counter()
    records = [policy_cli_run(torch, card)]
    print(json.dumps(records[-1]), flush=True)
    state = seeded_gpt2_state(torch, GPT2Config.small(), 0)
    judge = GPT2(GPT2Config.small(), device="cuda")
    judge.load_state_dict(state)
    judge_int8w = GPT2(
        dataclasses.replace(GPT2Config.small(), quant_matmul_fn=qm.quantized_matmul_reference),
        device="cuda", quantized=True,
    )
    judge_int8w.load_state_dict(quantize_gpt2_params(state))
    del state
    runs = (
        ("bf16_host", POLICY_ARGS + POLICY_HOST, FORMS[2], judge),
        ("int8_kv_host", POLICY_ARGS + POLICY_HOST + ["--kv-dtype", "int8"], FORMS[3], judge),
        ("int8_weights_recompute", POLICY_ARGS + INT8W_ARGS, FORMS[2], judge_int8w),
    )
    for name, args, form, j in runs:
        records.append(policy_run(torch, card, name, args, form, j))
    del judge, judge_int8w
    torch.cuda.empty_cache()
    # The int8-weight recompute run again in f32 (TF32 off): the resume
    # held within F32_TIE, where bf16's rounding does not hide a fault.
    f32 = GPT2Config.small(dtype=torch.float32)
    state = seeded_gpt2_state(torch, f32, 0)
    judge = GPT2(dataclasses.replace(f32, quant_matmul_fn=qm.quantized_matmul_reference),
                 device="cuda", quantized=True)
    judge.load_state_dict(quantize_gpt2_params(state))
    f32_run = policy_run(torch, card, "int8_weights_recompute_f32", POLICY_ARGS + INT8W_ARGS,
                         FORMS[2], judge, f32_state=state)
    del judge, state
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"phase 4p: {seconds:.1f} s", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_policy.json").write_text(json.dumps(
        {"card": card, "seconds": seconds, "runs": records + [f32_run]}, indent=1, default=str))
    return {r["run"]: {"attention": r["attention_launches_by_body"],
                       "matmul": r["matmul_launches"]} for r in records[1:]}


def policy_kernel_rows(cases: list, pol: dict) -> list:
    """The kernels line's rows of phase 4p: each paged form it drives at
    T 1 (the tick's split body) and at the prefill chunk's width (mma or
    q8mma: fresh prompts and resumed feeds alike), with 4p's launches of
    that body summed over its runs, phase 3b's case at the same shape for
    the rest; and the int8 matmul at the tick's 8 rows with the
    int8-weight run's launches."""
    rows = []
    for form in (FORMS[2], FORMS[3]):
        for t, suffix in ((1, ""), (64, "_prefill")):
            head = next(c for c in cases if c["form"] == form and c["dtype"] == "bfloat16"
                        and c["S"] == 512 and c["T"] == t and c.get("page_size") == 16)
            rows.append({
                "name": f"{form}_policy{suffix}", "route": "cuda", "path": head["path"],
                "source": "mpit_tpu_torch/csrc/decode_attention.cu",
                "replaces": "mpit_tpu/ops/decode_attention.py:166",
                "call_site": "mpit_tpu/ops/decode_attention.py:419",
                "launches": sum(r["attention"].get(f"{form}/{head['path']}", 0)
                                for r in pol.values()),
                "launches_by_run": {run: r["attention"].get(f"{form}/{head['path']}", 0)
                                    for run, r in pol.items()},
                **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                "shape": {k: head.get(k) for k in ("dtype", "kv", "page_size", "B", "S", "T",
                                                   "H", "Dh")},
            })
    head = next(c for c in cases if c["form"] == "quantized_matmul" and c["dtype"] == "bfloat16"
                and (c["M"], c["D"], c["F"]) == (8, 768, 2304))
    rows.append({
        "name": "quantized_matmul_policy", "route": "cuda", "path": head["path"],
        "source": "mpit_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "mpit_tpu/ops/quantized_matmul.py:272",
        "call_site": "mpit_tpu/ops/quantized_matmul.py:321",
        "launches": sum(r["matmul"] for r in pol.values()),
        **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "splits", "blocks")},
        "shape": {k: head[k] for k in ("dtype", "M", "D", "F")},
    })
    return rows


# Phase 4o: observability over the main paths. Serving: GPT-2 small on
# 4p's paged geometry (4 slots, 96 pages of 16, chunk 64), open loop at 4
# req/s for 1.5 s, drained, bf16 and int8 weights, through the CLI with an
# SLO, the sentinel and the trace; the obs CLI reads what it wrote (and a
# baseline snapshot made from its output). Then, in process on the same geometry, the closed-loop stream
# with obs off and on (tokens equal, decode tick p50 of each) and the
# decode kernel's visited tiles against the engine's model. Training:
# GPT-2 small on one rank, 10 steps with the sentinel and the profile
# window (the step's roofline over the steps outside it).
OBS_LOAD = "rate=4,prompt_min=16,prompt_max=64,new_min=16,new_max=32"
OBS_ARGS = POLICY_ARGS + ["--loadgen", OBS_LOAD, "--duration", "1.5", "--stats-interval", "1"]
OBS_FLAGS = ["--slo-ttft-p95", "0.5", "--sentinel", "true"]
OBS_TRAIN_ARGS = ["--flash", "true", "--steps", "10", "--log-every", "1", "--sentinel", "true"]


def obs_shares(entry: dict) -> dict:
    """A roofline entry's shares unrounded, from its achieved work and
    seconds against the card's bf16 and HBM peaks (the entry's own keep
    two decimals, and a decode tick's MFU rounds to 0.00)."""
    sec = entry.get("seconds") or 0.0
    if not sec or "mfu_pct" not in entry or "hbm_util_pct" not in entry:
        return {}
    return {"mfu": 100 * entry.get("achieved_flops", 0.0) / sec / PEAK_OPS_PER_S["bfloat16"],
            "hbm": 100 * entry.get("achieved_hbm_bytes", 0.0) / sec / HBM_BYTES_PER_S}


def obs_shares_ok(entry: dict) -> bool:
    """Both shares of a roofline entry in (0, 100]: a share past 100% is a
    fault of the timing, not a fast kernel."""
    shares = obs_shares(entry)
    return bool(shares) and all(0 < v <= 100 for v in shares.values())


def obs_serve_cli(torch, card, name: str, extra: list) -> dict:
    """One 4o CLI run: launches read around it, then the gates on what it
    returned and wrote, then the obs CLI over its files."""
    import contextlib
    import io

    from mpit_tpu_torch.obs import baseline
    from mpit_tpu_torch.obs.__main__ import main as obs_main
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.ops import quantized_matmul as qm
    from mpit_tpu_torch.serve.__main__ import main

    d = OUT / "chip_smoke_obs"
    d.mkdir(parents=True, exist_ok=True)
    tr, base, res = (d / f"{name}_{k}.json" for k in ("trace", "baseline", "out"))
    gc.collect()  # nothing earlier may be freed under the ledger's reconciliation
    for counts in (da.launches, da.path_launches, qm.launches, qm.path_launches):
        counts.update(dict.fromkeys(counts, 0))
    out = main(SERVE_ARGS + OBS_ARGS + extra + OBS_FLAGS + ["--trace", str(tr)])
    paths = {k: n for k, n in da.path_launches.items() if n}
    qmm = {k: n for k, n in qm.path_launches.items() if n}
    res.write_text(json.dumps(out, default=str))
    baseline.save(base, {"phases": out["obs_summary"], "roofline": out["roofline"]},
                  memory=out["memory"])
    tag = f"4o {name}"
    if out["requests_completed"] != out["load"]["arrivals"] or out["truncated"]:
        fail(f"{tag}: {out['requests_completed']} of {out['load']['arrivals']} answered")
    if set(paths) != {f"{FORMS[2]}/split", f"{FORMS[2]}/mma"}:
        fail(f"{tag}: attention launches by body {paths}")
    if ("--weights-dtype" in extra) != bool(qmm) or (qmm and set(qmm) != {"mma"}):
        fail(f"{tag}: quantized_matmul launches by body {qmm}")
    doc = json.loads(tr.read_text())
    spans = {ev["name"] for ev in doc["traceEvents"] if ev.get("ph") == "X"}
    if not {"prefill", "decode"} <= spans:
        fail(f"{tag}: the trace holds spans {sorted(spans)}")
    roof = out.get("roofline", {}).get("phases", {})
    name_now = torch.cuda.get_device_name(0)
    for phase in ("prefill", "decode"):
        entry = roof.get(phase, {})
        if not obs_shares_ok(entry) or entry.get("card") != name_now:
            fail(f"{tag}: roofline {phase} {entry}")
    mem = out["memory"]
    rec = mem["reconciliation"]
    if not mem["conservation"]["ok"] or not rec["within_tolerance"]:
        fail(f"{tag}: ledger conservation {mem['conservation']['ok']}, reconciliation {rec}")
    if "sentinel" not in out or "slo" not in out or not out.get("exemplars"):
        fail(f"{tag}: the sentinel, slo or exemplars block is missing")
    rcs = {}
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        for cmd, args in (("why-slow", [str(res)]), ("capacity", [str(res)]),
                          ("diff", [str(base), str(base)]), ("summary", [str(tr)])):
            rcs[cmd] = obs_main([cmd, *args])
    (d / f"{name}_obs_cli.txt").write_text(log.getvalue())
    if any(rcs.values()):
        fail(f"{tag}: obs CLI exit codes {rcs}")
    record = {
        "card": card, "run": name, "args": OBS_ARGS + extra + OBS_FLAGS,
        "load": out["load"], "requests_completed": out["requests_completed"],
        "launches_by_body": paths, "quantized_matmul_launches_by_body": qmm,
        "roofline": {ph: {k: roof[ph].get(k) for k in (
            "executions", "seconds", "mfu_pct", "hbm_util_pct", "achieved_hbm_gbps",
            "achieved_gflops_per_s", "bound_modeled", "card", "power_limit")}
            | {"shares_unrounded": obs_shares(roof[ph])} for ph in ("prefill", "decode")},
        "decode_tick_ms_p50": out["obs_summary"]["decode"]["p50_s"] * 1e3,
        "memory": {k: mem[k] for k in ("held_bytes", "held_peak_bytes", "held_by_subsystem",
                                       "kv_headroom_min_pct", "reconciliation")
                   if k in mem},
        "slo": out["slo"], "sentinel_clean": out["sentinel"]["clean"],
        "sentinel_counts": out["sentinel"]["anomaly_counts"],
        "exemplars": len(out["exemplars"]), "engine_compiles": out["engine_compiles"],
        "obs_cli": rcs,
    }
    print(json.dumps(record), flush=True)
    return record


def obs_serve_inprocess(torch, card, name: str, extra: list) -> dict:
    """4o in process: the CLI's engine for ``extra`` on 4o's geometry, the
    closed-loop synthetic stream with obs off, on, off, on (the recorder
    with registered costs, the sentinel, an SLO, the request ledger);
    greedy tokens must be equal in all four, and the decode tick p50 of
    each is kept. In the first obs-on run, after 6 ticks, the decode
    kernel run over the engine's pool at the live fills returns its
    visited tiles, which must equal the engine's model bit for bit."""
    import numpy as np

    from mpit_tpu_torch import obs
    from mpit_tpu_torch.config import from_argv
    from mpit_tpu_torch.obs import roofline
    from mpit_tpu_torch.ops import decode_attention as da
    from mpit_tpu_torch.serve import Server, warm_engine
    from mpit_tpu_torch.serve.__main__ import ServeConfig, _build_engine, synthetic_requests

    cfg = from_argv(ServeConfig, SERVE_ARGS + POLICY_ARGS + extra)
    engine, mcfg = _build_engine(cfg)
    reqs = list(synthetic_requests(cfg, mcfg.vocab_size))
    warm_engine(engine)
    runs, visited = [], None
    for with_obs in (False, True, False, True):
        engine.reset()
        reg = obs.StreamRegistry()
        kw = {}
        rec = obs.enable(obs.Recorder()) if with_obs else None
        if with_obs:
            engine.register_roofline()
            sent = obs.Sentinel(phases=("decode", "prefill"), warmup=4)
            kw = dict(sentinel=sent, ledger=obs.Ledger(mode="full"),
                      slo=obs.SLOMonitor([obs.SLO.ttft_p95(0.5)], reg, sentinel=sent))
        server = Server(engine, stream=reg, **kw)
        for r in reqs:
            server.submit(r)
        if with_obs and visited is None:
            server.run(max_ticks=6)
            fills = np.zeros(engine.slots, np.int32)
            for slot, live in server.live.items():
                fills[slot] = live.cache_fill()
            live_lens = fills[sorted(server.live)]
            q = torch.randn((engine.slots, 1, mcfg.num_heads, mcfg.head_dim),
                            device="cuda").bfloat16()
            c = engine.cache
            _, vis = da.flash_paged_decode_attention(
                q, c.k[0], c.v[0], torch.tensor(fills, device="cuda"), engine._block_tables(),
                block_k=engine.decode_block_k, return_visited=True)
            vis = vis.cpu().numpy()
            model = da.num_kv_blocks(fills, 1, engine.max_len, engine.decode_block_k)
            tiles = int(da.num_kv_blocks(live_lens, 1, engine.max_len,
                                         engine.decode_block_k).sum()) + engine.slots - len(
                live_lens)
            want = roofline.decode_step_hbm_bytes(
                int(vis.sum()), block_k=engine.decode_block_k, kv_row_bytes=engine._kv_row_bytes,
                num_layers=mcfg.num_layers, param_bytes=engine._param_bytes,
                appended_rows=len(live_lens))
            if not (np.array_equal(vis, model) and tiles == int(vis.sum())
                    and engine.decode_achieved_hbm_bytes(live_lens) == want):
                fail(f"4o {name}: kernel visited {vis.tolist()}, model {model.tolist()}, "
                     f"engine tiles {tiles}")
            visited = {"fills": fills.tolist(), "kernel_visited": vis.tolist(),
                       "engine_tiles": tiles}
        server.run()
        stats = server.stats()
        if rec is not None:
            obs.disable()
        tokens = {c.rid: c.tokens for c in server.completed}
        if len(tokens) != len(reqs) or not stats["memory"]["conservation"]["ok"]:
            fail(f"4o {name}: {len(tokens)} of {len(reqs)} completed, ledger "
                 f"{stats['memory']['conservation']['ok']}")
        runs.append({"obs": with_obs, "tokens": tokens,
                     "decode_tick_ms_p50": reg.total_sketch("decode_tick").quantile(0.5) * 1e3})
    if any(r["tokens"] != runs[0]["tokens"] for r in runs):
        fail(f"4o {name}: greedy tokens differ between obs off and on")
    record = {"card": card, "run": name, "visited": visited,
              "decode_tick_ms_p50": [(r["obs"], r["decode_tick_ms_p50"]) for r in runs]}
    print(json.dumps(record), flush=True)
    del engine
    torch.cuda.empty_cache()
    return record


def obs_train(torch, card) -> dict:
    """4o training: GPT-2 small, one rank, 10 steps through the flash
    kernels with the sentinel and the profile window (steps 2..5, in a
    temporary directory); the profiler's trace must hold the three flash
    kernels' device events, and the step's roofline shares lie in (0, 100]."""
    import importlib
    import tempfile

    from mpit_tpu_torch.asyncsgd.gpt2 import main
    from mpit_tpu_torch.utils.profiling import device_events

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    with tempfile.TemporaryDirectory() as tmp:
        out = main(OBS_TRAIN_ARGS + ["--profile-dir", tmp])
        events = device_events(out["profile"]["path"])
    launches = dict(fa.launches)
    names = [e["name"] for e in events]
    found = {k: sum(k in n for n in names) for k in ("fwd_kernel", "dq_kernel", "dkv_kernel")}
    if not all(found.values()):
        fail(f"4o train: the profiler's trace holds flash kernels {found}")
    roof = out["roofline"]["phases"]["step"]
    if not obs_shares_ok(roof) or out["steps"] != 10 or "sentinel" not in out:
        fail(f"4o train: steps {out['steps']}, roofline {roof}")
    if any(n < 12 * 10 for n in launches.values()):
        fail(f"4o train: flash launches {launches} < layers x steps")
    record = {
        "card": card, "run": "gpt2_train", "args": OBS_TRAIN_ARGS,
        "profile_device_events": len(events), "flash_events_in_profile": found,
        "launches": launches, "sentinel": out["sentinel"]["anomaly_counts"],
        "sentinel_clean": out["sentinel"]["clean"],
        "roofline": {k: roof.get(k) for k in ("executions", "seconds", "mfu_pct",
                                               "hbm_util_pct", "achieved_gflops_per_s",
                                               "bound_modeled", "card", "power_limit")}
        | {"shares_unrounded": obs_shares(roof)},
        "step_ms_p50": sorted(out["step_ms"][1:])[len(out["step_ms"][1:]) // 2],
    }
    print(json.dumps(record), flush=True)
    return record


def obs_phase(torch, card) -> dict:
    """Phase 4o: returns its records and the launches of its runs."""
    t0 = time.perf_counter()
    records = []
    for name, extra in (("bf16", []), ("int8_weights", INT8W_ARGS)):
        records.append(obs_serve_cli(torch, card, name, extra))
    for name, extra in (("bf16", []), ("int8_weights", INT8W_ARGS)):
        records.append(obs_serve_inprocess(torch, card, name, extra))
    records.append(obs_train(torch, card))
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_obs.json").write_text(json.dumps(records, indent=1, default=str))
    print(f"phase 4o: {time.perf_counter() - t0:.1f} s", flush=True)
    return {
        "paged_split": sum(r["launches_by_body"].get(f"{FORMS[2]}/split", 0)
                           for r in records[:2]),
        "paged_mma": sum(r["launches_by_body"].get(f"{FORMS[2]}/mma", 0) for r in records[:2]),
        "quantized_matmul": sum(records[1]["quantized_matmul_launches_by_body"].values()),
        **{f"flash_{k}": n for k, n in records[-1]["launches"].items()},
    }


# Phases 3t, 4mt and 4sq: GPT-2 small training on the model, fsdp and seq
# axes (the pjit tier and the context-parallel tier) over the flash
# kernels in their three new forms.
TIER_STEPS = 16
TIER_PROFILE_STEPS = 7  # the loop's profile window: steps 2..5
TIER_BATCH, TIER_T = 8, 512  # GPT-2 small's global batch and sequence
TP_TIER_RUNS = {  # name: (extra args, model ranks, data ranks)
    "tp_model2": (["--mesh", "model=2"], 2, 1),
    "tp_model4": (["--mesh", "model=4"], 4, 1),
    "tp_data2_model2_fsdp": (["--mesh", "data=2,model=2", "--fsdp-axis", "data"], 2, 2),
}
CP_TIER_RUNS = {  # name: (extra args, data ranks, seq ranks, flash, ulysses)
    "cp_ring_flash": (["--mesh", "data=2,seq=4"], 2, 4, True, False),
    "cp_ulysses_flash": (["--mesh", "data=4,seq=2", "--ulysses", "true"], 4, 2, True, True),
    "cp_ring": (["--mesh", "data=2,seq=4", "--flash", "false"], 2, 4, False, False),
}
TIER_PARITY_TOL = 1e-4  # relative, per-step loss, f32, against the one-rank step
RING_S, RING_TL = 4, 128  # the ring-flash run's seq ranks and T/S


def tier_args(steps: int) -> list:
    return ["--flash", "true", "--steps", str(steps), "--log-every", "1"]


def tier_geometries(name: str, layers: int) -> dict:
    """A tier run's flash launches of each kind by geometry ``(B, T, H,
    q_offset, k_offset)``, as the tier lays the work out: a TP run one
    launch a layer, model rank and data rank at the data rank's rows and
    its H/m heads; the ring-flash run one a layer, data rank and ring
    step ``s``, over the ``(S - s)·b`` rows of ranks ``s..S-1`` at
    offsets ``(s·T/S, 0)``; Ulysses one a layer and data rank over ``S·b``
    rows at H/S heads and the whole T; the plain ring none."""
    if name in TP_TIER_RUNS:
        _, m, d = TP_TIER_RUNS[name]
        return {(TIER_BATCH // d, TIER_T, H // m, 0, 0): layers * m * d * TIER_STEPS}
    _, d, s, flash, ulysses = CP_TIER_RUNS[name]
    b, n = TIER_BATCH // d, layers * d * TIER_STEPS
    if not flash:
        return {}
    if ulysses:
        return {(s * b, TIER_T, H // s, 0, 0): n}
    tl = TIER_T // s
    return {((s - st) * b, tl, H, st * tl, 0): n for st in range(s)}


def flash_form_case(torch, flush, form: str, name: str, b: int, t: int, h: int,
                    q_off: int = 0, k_off: int = 0, iters: int = 20) -> list:
    """The flash forward, dq and dk/dv kernels against their plain
    versions at one shape and placement: three records (errors, body,
    kernel, plain and library times, bound). The library call is SDPA
    where one computes the block: causal on the diagonal, unmasked on a
    wholly visible block, with the visibility mask otherwise; none for a
    wholly-future block (its o = 0 and lse = -1e30 are no SDPA's)."""
    import importlib

    import torch.nn.functional as F

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    dtype = getattr(torch, name)
    gen = torch.Generator(device="cuda").manual_seed(7 * b + t + h + 3 * q_off + k_off)
    q, k, v, do = (torch.randn((b, t, h, DH), generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    geo = dict(q_offset=q_off, k_offset=k_off, causal=True)
    before, before_kind = dict(fa.path_launches), dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, q_off, k_off, True)
    delta = fa._delta(o, do, None)
    got = {"o": o, "lse": lse, "dq": fa.flash_dq(q, k, v, do, lse, delta, q_off, k_off, True)}
    got["dk"], got["dv"] = fa.flash_dkv(q, k, v, do, lse, delta, q_off, k_off, True)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in fa.path_launches.items() if c != before[n]}
    body = "mma" if name == "bfloat16" else "fma"
    label = f"{form} {name} B={b} T={t} H={h} q_off={q_off} k_off={k_off}"
    if ran != {f"{kind}/{body}": 1 for kind in ("fwd", "dq", "dkv")}:
        fail(f"{label}: launches by body {ran}, expected one of each on {body}")
    p_o, p_lse = fa.flash_fwd_plain(q, k, v, **geo)
    p_delta = fa._delta(p_o, do, None)
    plain = {"o": p_o, "lse": p_lse,
             "dq": fa.flash_dq_plain(q, k, v, do, p_lse, p_delta, **geo)}
    plain["dk"], plain["dv"] = fa.flash_dkv_plain(q, k, v, do, p_lse, p_delta, **geo)
    errs = {}
    for key, ref in plain.items():
        err = (got[key].float() - ref.float()).abs().max().item()
        tol = LSE_TOL if key == "lse" else TOL[name]
        if not math.isfinite(err) or err > tol:
            fail(f"kernel vs plain {label}: {key} {err} > {tol}")
        errs[key] = err
    future = k_off >= q_off + t
    if future and not (bool((o == 0).all()) and bool((lse == -1e30).all())):
        fail(f"{label}: a future key block must give o = 0 and lse = -1e30 exactly")
    pairs = visible_pairs(t, q_off, k_off)
    library = library_device = {"fwd": None, "bwd": None}
    lib_name = "none computes a wholly-future block's o = 0, lse = -1e30"
    if not future:
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        if q_off == k_off:
            kw, lib_name = {"is_causal": True}, "sdpa causal"
        elif pairs == t * t:
            kw, lib_name = {}, "sdpa unmasked (every key visible)"
        else:
            vis = (q_off + torch.arange(t, device="cuda"))[:, None] >= (
                k_off + torch.arange(t, device="cuda"))[None, :]
            kw, lib_name = {"attn_mask": vis}, "sdpa with the visibility mask"
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, **kw)
        do_h = do.transpose(1, 2)
        lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)  # noqa: E731
        lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qh, kh, vh), do_h, retain_graph=True)
        library = {"fwd": cold_time_ms(lib_fwd, torch, flush, iters=iters),
                   "bwd": cold_time_ms(lib_bwd, torch, flush, iters=iters)}
        library_device = {
            "fwd": cold_time_ms(lib_fwd, torch, flush, iters=iters, lead_cycles=HOST_LEAD_CYCLES),
            "bwd": cold_time_ms(lib_bwd, torch, flush, iters=iters, lead_cycles=HOST_LEAD_CYCLES),
        }
    steps = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, q_off, k_off, True),
                lambda: fa.flash_fwd_plain(q, k, v, **geo), library["fwd"]),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, q_off, k_off, True),
               lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, **geo), library["bwd"]),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, q_off, k_off, True),
                lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, **geo), library["bwd"]),
    }
    out = []
    for kind, (kernel, plain_fn, lib_ms) in steps.items():
        lib_device_ms = library_device["fwd" if kind == "fwd" else "bwd"]
        bound_ms, bound_by = flash_bound(kind, b, t, h, DH, pairs, name)
        out.append({
            "form": form, "kernel": f"flash_{kind}", "path": body, "dtype": name,
            "B": b, "T": t, "H": h, "Dh": DH, "q_offset": q_off, "k_offset": k_off,
            "visible_pairs_per_head": pairs, "wholly_future": future,
            "max_abs_err": max(v for key, v in errs.items() if key != "lse"),
            "lse_err": errs["lse"], "tol": TOL[name],
            "ms": cold_time_ms(kernel, torch, flush, iters=iters),
            # Without the wrapper's host time before the launch.
            "device_ms": cold_time_ms(kernel, torch, flush, iters=iters,
                                      lead_cycles=HOST_LEAD_CYCLES),
            "plain_ms": cold_time_ms(plain_fn, torch, flush, iters=iters),
            "library_ms": lib_ms, "library_device_ms": lib_device_ms,
            "library": lib_name if kind == "fwd" or lib_ms is None
            else lib_name + " backward (dq, dk, dv in one call)",
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
    # The launches of the check and the timing are no main path's.
    fa.path_launches.update(before)
    fa.launches.update(before_kind)
    return out


def tier_kernel_phase(torch, flush) -> list:
    """Phase 3t: B2 in the tiers' forms against its plain version: on a
    TP rank's head shard (T 512, 6 and 3 heads, B 8; f32 at 6; 6 heads at
    B 4, a data rank's rows of data 2 x model 2), the ring
    block at every (q_offset, k_offset) of S 4 over T/S 128 (B 4, the
    wholly-future ones too, which the ring does not launch), the ring's
    launches (step s over ranks s..3: B (4 - s) x 4 at offsets (128 s,
    0); f32 at s 1) and Ulysses' inner call (T 512, 6 heads, B 4)."""
    t0 = time.perf_counter()
    cases = []
    runs = [("tp_head_shard", "bfloat16", FLASH_B, 512, 6, 0, 0),
            ("tp_head_shard", "bfloat16", FLASH_B, 512, 3, 0, 0),
            ("tp_head_shard", "float32", FLASH_B, 512, 6, 0, 0),
            ("tp_head_shard", "bfloat16", FLASH_B // 2, 512, 6, 0, 0)]
    runs += [("ring_block", "bfloat16", 4, RING_TL, H, r * RING_TL, src * RING_TL)
             for r in range(RING_S) for src in range(RING_S)]
    runs += [("ring_step", "bfloat16", (RING_S - s) * 4, RING_TL, H, s * RING_TL, 0)
             for s in range(RING_S)]
    runs += [("ring_step", "float32", (RING_S - 1) * 4, RING_TL, H, RING_TL, 0),
             ("ulysses_inner", "bfloat16", 4, 512, H // 2, 0, 0)]
    for form, name, b, t, h, q_off, k_off in runs:
        iters = 10 if form == "ring_block" else 20
        cases += flash_form_case(torch, flush, form, name, b, t, h, q_off, k_off, iters=iters)
        torch.cuda.empty_cache()
    print(f"phase 3t: {len(cases)} cases in {time.perf_counter() - t0:.1f} s", flush=True)
    return cases


def tier_losses_fall(name: str, losses: list) -> tuple[float, float]:
    import numpy as np

    if len(losses) != TIER_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{name}: {len(losses)} losses of {TIER_STEPS}, {losses}")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    if not last < first:
        fail(f"{name}: mean of the last four losses {last} >= the first four {first}")
    return first, last


def tier_run(torch, card, name: str, args: list, init: dict, want: dict) -> dict:
    """One tier run through ``asyncsgd.gpt2``'s ``main`` from ``init``
    (the seeded one-rank state), unpatched: the launch counts set to 0
    just before and read just after, by geometry held to ``want``
    (:func:`tier_geometries`, each kind) and by body all on ``mma``;
    falling finite losses; step time, tokens/s, MFU and peak memory."""
    import importlib

    import numpy as np

    from mpit_tpu_torch.asyncsgd.gpt2 import main

    fa = importlib.import_module("mpit_tpu_torch.ops.flash_attention")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches.update(dict.fromkeys(fa.launches, 0))
    fa.path_launches.update(dict.fromkeys(fa.path_launches, 0))
    fa.shape_launches.clear()
    t0 = time.perf_counter()
    out = main(tier_args(TIER_STEPS) + args, initial_params=init)
    wall = time.perf_counter() - t0
    by_shape = {k: n for k, n in fa.shape_launches.items() if n}
    bodies = {k: n for k, n in fa.path_launches.items() if n}
    want_shape = {(kind, *geo): n for geo, n in want.items() for kind in ("fwd", "dq", "dkv")}
    want_body = {f"{kind}/mma": sum(want.values()) for kind in ("fwd", "dq", "dkv")} if want else {}
    if by_shape != want_shape or bodies != want_body:
        fail(f"{name}: flash launches by geometry {by_shape} and by body {bodies}, "
             f"expected {want_shape} and {want_body}")
    first, last = tier_losses_fall(name, out["losses"])
    step_ms = np.asarray(out["step_ms"][2:])
    record = {
        "run": name, "args": tier_args(TIER_STEPS) + args, "tier": out["tier"],
        "world": out["world"], "steps": out["steps"], "losses": out["losses"],
        "first4_mean": first, "last4_mean": last, "launches_by_body": bodies,
        "launches_by_geometry": {" ".join(map(str, k)): n for k, n in sorted(by_shape.items())},
        "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_p95": float(np.percentile(step_ms, 95)),
        "tokens_per_sec": out.get("items_per_sec"),
        "roofline": (out.get("roofline") or {}).get("phases", {}).get("step"),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "wall_s": wall,
    }
    print(json.dumps({"card": card, "tier_run": record}), flush=True)
    return record, {k: n for k, n in by_shape.items()}


def tier_rows_finite(torch, name: str, args: list, init: dict, steps: int = 2) -> int:
    """A short untimed run of a CP tier through ``main`` with every call of
    its sequence attention checked on the card (each merged row finite,
    read once at the end); the timed run is left unpatched. Returns the
    calls checked."""
    import importlib

    from mpit_tpu_torch.asyncsgd.gpt2 import main

    cp = importlib.import_module("mpit_tpu_torch.parallel.cp")
    seq_attention, finite = cp.make_seq_attention, []

    def checked_seq_attention(*a, **kw):
        fn = seq_attention(*a, **kw)

        def attention_fn(q, k, v, *, causal=True):
            o = fn(q, k, v, causal=causal)
            finite.append(torch.isfinite(o).all())
            return o

        return attention_fn

    cp.make_seq_attention = checked_seq_attention
    try:
        main(tier_args(steps) + args, initial_params=init)
    finally:
        cp.make_seq_attention = seq_attention
    if not finite or not bool(torch.stack(finite).all()):
        fail(f"{name}: {len(finite)} sequence-attention calls, not every merged row finite")
    return len(finite)


def trace_breakdown(path: str, steps: int, families=None) -> dict:
    """Device busy time by kernel family (:data:`FAMILIES`) and the
    device's idle share of a profile window, from its Chrome trace: busy
    the sum of the device events' durations, the window's wall the span
    of all its events, both over ``steps`` steps."""
    from mpit_tpu_torch.utils.profiling import device_events

    families = FAMILIES if families is None else families
    doc = json.loads(Path(path).read_text())
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in doc.get("traceEvents", []) if e.get("ph") == "X" and "ts" in e]
    wall_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    busy, kernels = {}, {}
    for e in device_events(path):
        name = e["name"].lower()
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)), "other")
        busy[fam] = busy.get(fam, 0.0) + float(e.get("dur", 0)) / 1e3
        kernels[e["name"][:80]] = kernels.get(e["name"][:80], 0.0) + float(e.get("dur", 0)) / 1e3
    total = sum(busy.values())
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": total / steps,
        "device_idle_share": max(0.0, 1.0 - total / wall_ms),
        "busy_ms_per_step_by_family": {f: v / steps for f, v in sorted(busy.items())},
        "top_kernels_ms_per_step": {
            k: v / steps for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        },
    }


def tier_main_profile(torch, args: list, init: dict) -> dict:
    """A tier's main path profiled by its own loop: ``main`` with
    ``--profile-dir`` (steps 2..5 under ``torch.profiler``, in a temporary
    directory), read by :func:`trace_breakdown`."""
    import tempfile

    from mpit_tpu_torch.asyncsgd.gpt2 import main

    with tempfile.TemporaryDirectory() as tmp:
        out = main(tier_args(TIER_PROFILE_STEPS) + args + ["--profile-dir", tmp],
                   initial_params=init)
        prof = trace_breakdown(out["profile"]["path"], 4)
    gc.collect()
    torch.cuda.empty_cache()
    return prof


def tier_step(torch, mesh: dict, cfg, init: dict, *, flash: bool, ulysses: bool = False):
    """``(state, step_fn)`` of the pjit tier (a model axis) or the CP tier
    (a seq axis) over ``mesh`` on the card, built as ``asyncsgd.gpt2``
    builds it, from the one-rank state ``init``; one rank when ``mesh``
    is empty (the pjit tier's unfused loss)."""
    import dataclasses

    from mpit_tpu_torch import comm
    from mpit_tpu_torch.models import GPT2, default_attention
    from mpit_tpu_torch.ops.flash_attention import flash_attention
    from mpit_tpu_torch.opt import goo_adam
    from mpit_tpu_torch.parallel.cp import make_gpt2_cp_train_step
    from mpit_tpu_torch.parallel.tp import gpt2_tp_rules, make_tp_train_step
    from mpit_tpu_torch.serve.tp import TPGPT2
    from mpit_tpu_torch.serve.weights import shard_gpt2_params
    from mpit_tpu_torch.train import make_train_step

    tx = goo_adam(3e-4)
    if "seq" in mesh:
        world = comm.init({"data": 1, **mesh}, devices=["cuda"])
        init_fn, step_fn, _ = make_gpt2_cp_train_step(cfg, tx, world, flash=flash,
                                                      ulysses=ulysses)
        return init_fn(init), lambda st, b: step_fn(st, {"tokens": b["tokens"][:, :-1]})
    cfg = dataclasses.replace(cfg, attention_fn=flash_attention if flash else default_attention)
    if not mesh:
        model = GPT2(cfg, device="cuda")
        model.load_state_dict(init)
        init_fn, step_fn = make_train_step(
            lambda p, b: (GPT2.loss_fn(model(b["tokens"][:, :-1]), b["tokens"]), {}), tx)
        return init_fn(dict(model.named_parameters())), step_fn
    world = comm.init(mesh, devices=["cuda"])
    m = world.size("model")
    model = TPGPT2(cfg, m, device="cuda", vocab_parallel=True)
    model.load_state_dict(shard_gpt2_params(init, m, vocab_parallel=True))

    def loss_fn(params, batch):
        t = batch["tokens"]
        return model(t[:, :-1], targets=t[:, 1:]).mean(), {}

    init_fn, step_fn, _ = make_tp_train_step(
        loss_fn, tx, world, gpt2_tp_rules(), fsdp_axis="data" if "data" in mesh else None)
    return init_fn(dict(model.named_parameters())), step_fn


def tier_batches(torch, cfg, n: int, batch: int = 8):
    from mpit_tpu_torch.data import SyntheticLM

    stream = SyntheticLM(vocab_size=cfg.vocab_size, seed=0).batches(batch, cfg.max_seq_len)
    return [{"tokens": torch.from_numpy(next(stream)["tokens"]).long().cuda()}
            for _ in range(n)]


def tier_parity_phase(torch) -> dict:
    """f32 (TF32 off) parity of both tiers at full width and 2 layers,
    three goo_adam steps from one seeded state: the pjit tier at model 2,
    model 4 and data 2 x model 2 with FSDP against the one-rank step of
    its unfused loss; the CP tier (ring-flash, Ulysses-flash, plain ring)
    against its one-rank step (one seq rank, one data rank). Per-step
    losses within ``TIER_PARITY_TOL`` relative."""
    from mpit_tpu_torch.models import GPT2Config

    cfg = GPT2Config.small(dtype=torch.float32, num_layers=2, max_seq_len=512)
    init = seeded_gpt2_state(torch, cfg, 0)
    batches = tier_batches(torch, cfg, 3)
    cases = {  # name: (reference mesh, mesh, flash, ulysses)
        "tp_model2": ({}, {"model": 2}, True, False),
        "tp_model4": ({}, {"model": 4}, True, False),
        "tp_data2_model2_fsdp": ({}, {"data": 2, "model": 2}, True, False),
        "cp_ring_flash": ({"seq": 1}, {"data": 2, "seq": 4}, True, False),
        "cp_ulysses_flash": ({"seq": 1}, {"data": 4, "seq": 2}, True, True),
        "cp_ring": ({"seq": 1}, {"data": 2, "seq": 4}, False, False),
    }
    refs, out = {}, {}
    for name, (ref, mesh, flash, ulysses) in cases.items():
        losses = {}
        for label, m, fl, uly in (("ref", ref, flash, False), ("tier", mesh, flash, ulysses)):
            key = (str(ref), fl) if label == "ref" else None
            if key in refs:
                losses[label] = refs[key]
                continue
            state, step_fn = tier_step(torch, m, cfg, init, flash=fl, ulysses=uly)
            losses[label] = []
            for b in batches:
                state, metrics = step_fn(state, b)
                losses[label].append(metrics["loss"].item())
            if key is not None:
                refs[key] = losses[label]
            del state, step_fn
            gc.collect()
            torch.cuda.empty_cache()
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["tier"], losses["ref"])]
        if not max(rel) <= TIER_PARITY_TOL:
            fail(f"tier parity {name}: losses {losses} differ by {rel} > {TIER_PARITY_TOL}")
        out[name] = {"losses": losses, "max_rel_diff": max(rel)}
    print(json.dumps({"tier_parity_f32": out}), flush=True)
    return out


def tier_phases(torch, card, flush) -> dict:
    """Phases 3t, 4mt and 4sq (the f32 parity of both tiers, then the
    full-width runs, a profile of one run of each tier through its main
    path and the CP runs' merged rows checked in short runs of their
    own); records in ``chiprun_out/chip_smoke_tiers.json``. Returns the
    3t cases and each run's flash launches by geometry."""
    from mpit_tpu_torch.asyncsgd.config import from_argv
    from mpit_tpu_torch.asyncsgd.gpt2 import GPT2TrainConfig

    t0 = time.perf_counter()
    cases = tier_kernel_phase(torch, flush)
    t1 = time.perf_counter()
    parity = tier_parity_phase(torch)
    t2 = time.perf_counter()
    tcfg = from_argv(GPT2TrainConfig, tier_args(TIER_STEPS))
    if (tcfg.batch_size, tcfg.seq_len) != (TIER_BATCH, TIER_T):
        fail(f"the tiers' batch and sequence {tcfg.batch_size}, {tcfg.seq_len} are not "
             f"{TIER_BATCH}, {TIER_T}")
    cfg = tcfg.model_config()
    init = seeded_gpt2_state(torch, cfg, 0)
    layers = cfg.num_layers
    runs, launches = {}, {}
    for name, (args, _, _) in TP_TIER_RUNS.items():
        runs[name], launches[name] = tier_run(torch, card, name, args, init,
                                              tier_geometries(name, layers))
    runs["tp_model2"]["profile"] = tier_main_profile(torch, TP_TIER_RUNS["tp_model2"][0], init)
    t3 = time.perf_counter()
    for name, (args, *_) in CP_TIER_RUNS.items():
        runs[name], launches[name] = tier_run(torch, card, name, args, init,
                                              tier_geometries(name, layers))
        runs[name]["seq_attention_calls_checked_finite"] = tier_rows_finite(
            torch, name, args, init)
    runs["cp_ring_flash"]["profile"] = tier_main_profile(
        torch, CP_TIER_RUNS["cp_ring_flash"][0], init)
    t4 = time.perf_counter()
    seconds = {"3t": t1 - t0, "parity": t2 - t1, "4mt": t3 - t2, "4sq": t4 - t3}
    print(f"phases 3t, 4mt, 4sq: {seconds}", flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_tiers.json").write_text(json.dumps(
        {"card": card, "seconds": seconds, "cases": cases, "runs": runs,
         "parity_f32": parity}, indent=1, default=str))
    return {"cases": cases, "launches": launches}


def tier_kernel_rows(tiers: dict) -> list:
    """The kernels line's rows of phases 3t, 4mt and 4sq: each flash
    kernel at each geometry a tier run launched it, with that run's
    launches at that geometry as the launch counts read them and the 3t
    case of the same form and geometry: a TP rank's head shard (6 heads
    at B 8: model 2; 3 heads: model 4; 6 heads at B 4: data 2 x model 2
    with FSDP), each ring step's launch of the ring-flash run, and
    Ulysses' inner call."""
    rows = []
    sources = {"fwd": (121, 362), "dq": (195, 408), "dkv": (237, 428)}
    groups = [  # (row suffix, 3t form, run, (B, T, H, q_offset, k_offset))
        ("tp6", "tp_head_shard", "tp_model2", (FLASH_B, TIER_T, H // 2, 0, 0)),
        ("tp3", "tp_head_shard", "tp_model4", (FLASH_B, TIER_T, H // 4, 0, 0)),
        ("tp6_fsdp", "tp_head_shard", "tp_data2_model2_fsdp",
         (FLASH_B // 2, TIER_T, H // 2, 0, 0)),
        *[(f"ring_s{s}", "ring_step", "cp_ring_flash",
           ((RING_S - s) * 4, RING_TL, H, s * RING_TL, 0)) for s in range(RING_S)],
        ("ulysses", "ulysses_inner", "cp_ulysses_flash", (4, TIER_T, H // 2, 0, 0)),
    ]
    for suffix, form, run, geo in groups:
        b, t, h, q_off, k_off = geo
        for kind, (body, call) in sources.items():
            head = next(c for c in tiers["cases"] if c["form"] == form and c["B"] == b
                        and c["T"] == t and c["H"] == h and c["q_offset"] == q_off
                        and c["k_offset"] == k_off and c["dtype"] == "bfloat16"
                        and c["kernel"] == f"flash_{kind}")
            n = tiers["launches"][run].get((kind, *geo), 0)
            rows.append({
                "name": f"flash_{kind}_{suffix}", "route": "cuda", "path": head["path"],
                "source": "mpit_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"mpit_tpu/ops/flash_attention.py:{body}",
                "call_site": f"mpit_tpu/ops/flash_attention.py:{call}",
                "launches": n, "launches_by_run": {run: n},
                **{k: head[k] for k in ("max_abs_err", "tol", "ms", "device_ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "library_device_ms", "library")},
                "shape": {k: head[k] for k in ("dtype", "B", "T", "H", "Dh", "q_offset",
                                               "k_offset")},
            })
    return rows


def main() -> None:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        fail("CUDA is not available")
    import_port()
    load_peaks()
    # Full-precision f32 matmuls wherever f32 results are compared.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from mpit_tpu_torch.ops import build

    if sys.argv[1:2] == ["dp_profile"]:  # the phase-4d profile of one mode alone
        build.build(build.KERNEL_SOURCES)
        print(json.dumps({"card": card, "train_dp_profile": dp_profile(torch, sys.argv[2])}))
        return
    if sys.argv[1:2] == ["convnets"]:  # the convnet phases alone (4c, 4cd, 4cp, 5c)
        build.build(build.KERNEL_SOURCES)
        conv = convnet_phases(torch, card, convnet_bucket_plans(torch))
        print(json.dumps({"card": card, "convnet_launches": conv["launches"]}))
        return
    if sys.argv[1:2] == ["resnet"]:  # 3e at ResNet-50's plan, then 4r, 4rd and 5r alone
        build.build(build.KERNEL_SOURCES)
        plans = convnet_bucket_plans(torch)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        warm_up(torch)
        cases = plan_ring_cases(torch, flush, {"resnet50": plans["resnet50"]})
        from mpit_tpu_torch.ops import ring_collectives as rc

        if rc.device_error():
            fail(rc.device_error())
        del flush
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_ring_resnet.json").write_text(json.dumps(
            {"card": card, "bucket_plan": plans["resnet50"], "cases": cases}, indent=1))
        res = resnet_phases(torch, card, plans)
        print(json.dumps({"card": card, "resnet_launches": res["launches"]}))
        return
    if sys.argv[1:2] == ["elastic"]:  # phase 4e alone, run N times (default once)
        import tempfile

        build.build(build.KERNEL_SOURCES)
        reps = int(sys.argv[2]) if len(sys.argv) > 2 else 1
        with tempfile.TemporaryDirectory() as d:
            records = [elastic_phase(torch, card, Path(d) / str(i))["records"]
                       for i in range(reps)]
        healthy = [r["elastic_healthy"] for r in records]
        summary = {
            "repeats": reps,
            "healthy_runs_with_a_jump": sum(bool(h["replicas_with_jumps"]) for h in healthy),
            "jumps": [(i, r, h["every_replica"][r]["jumps"]) for i, h in enumerate(healthy)
                      for r in h["replicas_with_jumps"]],
            "old_gate_failures": sum(not h["old_gate"]["passes"] for h in healthy),
            "eval_on_centre_max": max(h["eval_on_centre"]["loss"] for h in healthy),
        }
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_elastic.json").write_text(json.dumps(
            {"card": card, "summary": summary, "repeats": records}, indent=1, default=str))
        print(json.dumps({"card": card, "elastic_summary": summary}, default=str))
        return
    if sys.argv[1:2] == ["spec"]:  # phases 3s, 4s, 5s and 4z alone
        build.build(build.KERNEL_SOURCES)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        warm_up(torch)
        serve_records = []
        for args, form in (([], FORMS[0]), (PAGED_ARGS, FORMS[2]),
                           (PAGED_ARGS + ["--kv-dtype", "int8"], FORMS[3]), (INT8W_ARGS, FORMS[0])):
            serve_phase(torch, card, args, form, serve_records)
        mcfg, state, _ = parity_phase(torch)
        spec = spec_phases(torch, card, flush, serve_records, mcfg, state,
                           convnet_bucket_plans(torch), {})
        print(json.dumps({"card": card, "spec_launches": spec["serve"]["bodies"],
                          "easgd_launches": spec["easgd"]["launches"]}))
        print(f"chip_smoke spec: {time.perf_counter() - t_start:.1f} s in all", flush=True)
        return
    if sys.argv[1:2] == ["tp"]:  # phases 3m, 4m and 5m alone
        build.build(build.KERNEL_SOURCES)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        warm_up(torch)
        mcfg, state, one_rank = parity_phase(torch)
        tp = tp_phases(torch, card, flush, mcfg, state, one_rank, {})
        print(json.dumps({"card": card, "tp_launches": tp["serve"]["bodies"],
                          "tp_matmul_launches": tp["serve"]["qmm"]}))
        print(json.dumps({"kernels": tp_kernel_rows(tp)}))
        print(f"chip_smoke tp: {time.perf_counter() - t_start:.1f} s in all", flush=True)
        return
    if sys.argv[1:2] == ["policy"]:  # phase 4p alone
        build.build(build.KERNEL_SOURCES)
        pol = policy_phase(torch, card)
        print(json.dumps({"card": card, "policy_launches": pol}))
        print(f"chip_smoke policy: {time.perf_counter() - t_start:.1f} s in all", flush=True)
        return
    if sys.argv[1:2] == ["obs"]:  # phase 4o alone
        build.build(build.KERNEL_SOURCES)
        launches = obs_phase(torch, card)
        print(json.dumps({"card": card, "obs_launches": launches}))
        print(f"chip_smoke obs: {time.perf_counter() - t_start:.1f} s in all", flush=True)
        return
    if sys.argv[1:2] == ["tiers"]:  # phases 3t, 4mt and 4sq alone
        build.build(build.KERNEL_SOURCES)
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
        warm_up(torch)
        tiers = tier_phases(torch, card, flush)
        print(json.dumps({"card": card, "tier_launches": {
            run: {" ".join(map(str, k)): n for k, n in sorted(by.items())}
            for run, by in tiers["launches"].items()}}))
        print(json.dumps({"kernels": tier_kernel_rows(tiers)}))
        print(f"chip_smoke tiers: {time.perf_counter() - t_start:.1f} s in all", flush=True)
        return
    if sys.argv[1:2] == ["recovery"]:  # phases 4k, 4kd, 4kx and 4e alone
        build.build(build.KERNEL_SOURCES)
        rec = recovery_phases(torch, card, convnet_bucket_plans(torch))
        print(json.dumps({"card": card, "recovery_launches": rec["launches"]}))
        print(f"chip_smoke recovery: {time.perf_counter() - t_start:.1f} s in all", flush=True)
        return
    t0 = time.perf_counter()
    logs = build.build(build.KERNEL_SOURCES, force=True)
    build_s = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_build.log").write_text(
        "\n".join(f"== {src}\n{log}" for src, log in logs.items())
    )
    print(f"build: {len(logs)} source(s) in {build_s:.2f} s", flush=True)

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    warm_up(torch)
    cases = (
        kernel_phase(torch, flush) + paged_kernel_phase(torch, flush)
        + qmm_kernel_phase(torch, flush)
    )
    flash_cases = flash_kernel_phase(torch, flush)
    plan = dp_bucket_plan(torch)
    conv_plans = convnet_bucket_plans(torch)
    ring_cases = ring_kernel_phase(torch, flush, plan["tail_rows"], conv_plans)
    t0 = time.perf_counter()
    ship_cases = ship_kernel_phase(torch, flush)
    print(f"phase 3f: {time.perf_counter() - t0:.1f} s", flush=True)
    (OUT / "chip_smoke_ship.json").write_text(
        json.dumps({"card": card, "cases": ship_cases}, indent=1)
    )
    (OUT / "chip_smoke_ring.json").write_text(json.dumps(
        {"card": card, "bucket_plan": plan, "convnet_bucket_plans": conv_plans,
         "cases": ring_cases}, indent=1
    ))
    (OUT / "chip_smoke_kernels.json").write_text(json.dumps({"card": card, "cases": cases}, indent=1))
    (OUT / "chip_smoke_flash.json").write_text(
        json.dumps({"card": card, "cases": flash_cases}, indent=1)
    )
    # Each run: (extra args, the attention form it drives).
    runs = {
        "dense": ([], FORMS[0]),
        "paged": (PAGED_ARGS, FORMS[2]),
        "paged_int8_kv": (PAGED_ARGS + ["--kv-dtype", "int8"], FORMS[3]),
        "dense_int8_kv": (["--kv-dtype", "int8"], FORMS[1]),
        "dense_int8_weights": (INT8W_ARGS, FORMS[0]),
        "paged_int8_weights_int8_kv": (
            PAGED_ARGS + INT8W_ARGS + ["--kv-dtype", "int8"], FORMS[3]
        ),
    }
    serve_records = []
    counts = {name: serve_phase(torch, card, *run, serve_records) for name, run in runs.items()}
    t0 = time.perf_counter()
    serve_records.append({"card": card, "int8w_serve_profile": int8w_serve_profile(torch)})
    print(json.dumps(serve_records[-1]), flush=True)
    print(f"phase 4q: {time.perf_counter() - t0:.1f} s", flush=True)
    (OUT / "chip_smoke_serve.json").write_text(json.dumps(serve_records, indent=1))
    # An attention form's launches by body: its run without int8 weights.
    body_launches = {}
    for name, (args, form) in runs.items():
        if "--weights-dtype" not in args:
            body_launches.update(counts[name][2])
    qmm_launches = {name: c[1] for name, c in counts.items() if c[1]}
    qmm_bodies = {}
    for c in counts.values():
        for body, n in c[3].items():
            qmm_bodies[body] = qmm_bodies.get(body, 0) + n
    t0 = time.perf_counter()
    tokens = {}  # the plain runs' greedy tokens, shared by 4f and 4s
    ship_launches, fleet_records = fleet_phase(torch, card, ship_cases, tokens)
    print(f"phase 4f: {time.perf_counter() - t0:.1f} s", flush=True)
    mcfg, state, one_rank = parity_phase(torch)
    paged_parity_phase(torch, mcfg, state)
    int8w_parity_phase(torch, mcfg, state)
    spec = spec_phases(torch, card, flush, serve_records, mcfg, state, conv_plans, tokens)
    tp = tp_phases(torch, card, flush, mcfg, state, one_rank, tokens, serve_records)
    del mcfg, state
    pol = policy_phase(torch, card)
    obs_launches = obs_phase(torch, card)
    t0 = time.perf_counter()
    fleet_parity = fleet_parity_phase(torch)
    print(f"phase 5f: {time.perf_counter() - t0:.1f} s", flush=True)
    (OUT / "chip_smoke_fleet.json").write_text(json.dumps(
        {"card": card, "fleet_runs": fleet_records, "parity_fleet_f32": fleet_parity}, indent=1
    ))
    flash_launches = train_phase(torch, card, flush)
    train_parity_phase(torch)
    tiers = tier_phases(torch, card, flush)
    del flush
    ring_launches, q8_forms = {}, {}
    dp_losses = {}
    for mode in ("ring", "ring_q8"):
        counts, forms, dp_losses[mode] = dp_train_phase(torch, card, mode, plan)
        ring_launches.update({k: n for k, n in counts.items() if n})
        q8_forms.update({k: n for k, n in forms.items() if n})
    for mode in ("ring", "ring_q8"):
        print(json.dumps({"card": card, "train_dp_profile": dp_profile(torch, mode)}),
              flush=True)
    dp_parity_phase(torch, dp_losses["ring_q8"])
    conv = convnet_phases(torch, card, conv_plans)
    res = resnet_phases(torch, card, conv_plans)
    rec = recovery_phases(torch, card, conv_plans)
    # The ring kernels' launches by run: the convnets', ResNet-50's and the
    # checkpointed runs' (4k, 4kx).
    ring_runs = {**conv["launches"]["ring"], **res["launches"], **rec["launches"]["ring"]}

    kernels = []
    # Each decode form twice: at T 1 (the tick, split body) and at its
    # prefill width (T 128 dense, T 64 paged: the serving runs' prefill
    # and prefill chunk), with the main path's launches of the body that
    # case ran.
    for form in FORMS:
        width = 64 if "paged" in form else 128
        for t, suffix in ((1, ""), (width, "_prefill")):
            head = next(
                c for c in cases
                if c["form"] == form and c["dtype"] == "bfloat16" and c["S"] == 512
                and c["T"] == t and c.get("page_size") in (None, 16)
            )
            kernels.append({
                "name": form + suffix,
                "route": "cuda",
                "path": head["path"],
                "source": "mpit_tpu_torch/csrc/decode_attention.cu",
                "replaces": "mpit_tpu/ops/decode_attention.py:166",
                "call_site": (
                    "mpit_tpu/ops/decode_attention.py:419" if "paged" in form
                    else "mpit_tpu/ops/decode_attention.py:369"
                ),
                "launches": body_launches.get(f"{form}/{head['path']}", 0),
                **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                "shape": {k: head.get(k) for k in ("dtype", "kv", "page_size", "B", "S", "T",
                                                   "H", "Dh")},
            })
    # Each decode form at the speculative verify's width (T = k + 1 = 5),
    # with phase 4s's launches of that form (prefill and verify, one body).
    spec_runs = {FORMS[0]: "spec_dense", FORMS[2]: "spec_paged", FORMS[3]: "spec_paged_int8_kv"}
    for form, run in spec_runs.items():
        head = next(c for c in spec["cases"] if c["form"] == form and c["T"] == SPEC_K + 1
                    and c.get("page_size") in (None, 16))
        kernels.append({
            "name": form + "_verify",
            "route": "cuda",
            "path": head["path"],
            "source": "mpit_tpu_torch/csrc/decode_attention.cu",
            "replaces": "mpit_tpu/ops/decode_attention.py:166",
            "call_site": (
                "mpit_tpu/ops/decode_attention.py:419" if "paged" in form
                else "mpit_tpu/ops/decode_attention.py:369"
            ),
            "launches": spec["serve"]["bodies"][run].get(f"{form}/{head['path']}", 0),
            **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")},
            "shape": {k: head.get(k) for k in ("dtype", "kv", "page_size", "B", "S", "T",
                                               "H", "Dh")},
        })
    # The decode tick's qkv projection at bf16 activations.
    head = next(
        c for c in cases
        if c["form"] == "quantized_matmul" and c["dtype"] == "bfloat16"
        and (c["M"], c["D"], c["F"]) == (8, 768, 2304)
    )
    kernels.append({
        "name": "quantized_matmul",
        "route": "cuda",
        "source": "mpit_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "mpit_tpu/ops/quantized_matmul.py:272",
        "call_site": "mpit_tpu/ops/quantized_matmul.py:321",
        "path": head["path"],
        "launches": sum(qmm_launches.values()),
        "launches_by_run": qmm_launches,
        "launches_by_body": qmm_bodies,
        **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "splits", "blocks")},
        "shape": {k: head[k] for k in ("dtype", "M", "D", "F")},
    })
    # The verify's qkv projection: 8 slots x (k + 1) rows, phase 4s's
    # int8-weight run (the target's and the draft's matmuls).
    head = next(c for c in spec["cases"] if c["form"] == "quantized_matmul"
                and (c["M"], c["D"], c["F"]) == (SPEC_QMM_ROWS, 768, 2304))
    kernels.append({
        "name": "quantized_matmul_verify",
        "route": "cuda",
        "source": "mpit_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "mpit_tpu/ops/quantized_matmul.py:272",
        "call_site": "mpit_tpu/ops/quantized_matmul.py:321",
        "path": head["path"],
        "launches": spec["serve"]["qmm"]["spec_dense_int8_weights"],
        **{k: head[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "splits", "blocks")},
        "shape": {k: head[k] for k in ("dtype", "M", "D", "F")},
    })
    kernels += tp_kernel_rows(tp)
    kernels += policy_kernel_rows(cases, pol)
    # Phase 4o's own launches, beside each row's main-path count.
    obs_rows = {f"{FORMS[2]}": "paged_split", f"{FORMS[2]}_prefill": "paged_mma",
                "quantized_matmul": "quantized_matmul"}
    for row in kernels:
        key = obs_rows.get(row["name"])
        if key is not None:
            row["launches_4o"] = obs_launches[key]
    flash_sources = {"fwd": (121, 362), "dq": (195, 408), "dkv": (237, 428)}
    for kind, (body, call) in flash_sources.items():
        head = next(
            c for c in flash_cases
            if c["form"] == f"flash_{kind}" and c["dtype"] == "bfloat16" and c["T"] == 512
            and not c["q_offset"] and not c["k_offset"] and not c["g_lse"]
            and c["fused_qkv_views"]
        )
        kernels.append({
            "name": f"flash_{kind}",
            "route": "cuda",
            "path": head["path"],
            "source": "mpit_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"mpit_tpu/ops/flash_attention.py:{body}",
            "call_site": f"mpit_tpu/ops/flash_attention.py:{call}",
            "launches": flash_launches[kind] + sum(
                r.get(kind, 0) for r in rec["launches"]["flash"].values()),
            "launches_by_run": {"gpt2_train": flash_launches[kind], **{
                run: r[kind] for run, r in rec["launches"]["flash"].items()}},
            "launches_4o": obs_launches[f"flash_{kind}"],
            "max_abs_err": max(v for k, v in head["max_abs_err"].items()),
            **{k: head[k] for k in ("tol", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library")},
            "shape": {k: head[k] for k in ("dtype", "B", "T", "H", "Dh")},
        })
    kernels += tier_kernel_rows(tiers)
    ring_bodies = {"ring_rs": 350, "ring_rs_q8": 387, "ring_ag": 429, "ring_ag_q8": 457}
    for name, body in ring_bodies.items():
        head = next(
            c for c in ring_cases
            if c["form"] == name and c["p"] == DP_RANKS and c["rows"] == RING_ROWS
            and c["dtype"] == "float32"
        )
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mpit_tpu_torch/csrc/ring_collectives.cu",
            "replaces": f"mpit_tpu/ops/ring_collectives.py:{body}",
            "call_site": "mpit_tpu/ops/ring_collectives.py:550",
            "launches": ring_launches[name] + sum(r.get(name, 0) for r in ring_runs.values()),
            "launches_by_run": {"gpt2_dp": ring_launches[name], **{
                run: r[name] for run, r in ring_runs.items() if name in r}},
            **{k: head[k] for k in ("schedule", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "library", "ring_schedule_bytes",
                                    "device_ms")},
            "shape": {k: head[k] for k in ("dtype", "p", "rows")},
        })
        if name.endswith("_q8"):  # no PyTorch call computes the q8 wire
            kernels[-1].update(library_ms=None, library="none computes the q8 wire",
                               sum_library_ms=head["library_ms"],
                               launches_by_form={
                                   f: n for f, n in q8_forms.items()
                                   if f.split("_")[0] == head["schedule"].split("_")[0]})
    head = next(c for c in ship_cases if c["label"] == "payload bf16")
    kernels.append({
        "name": "kv_ship",
        "route": "cuda",
        "source": "mpit_tpu_torch/csrc/kv_ship.cu",
        "replaces": "mpit_tpu/serve/shipment.py:301",
        "call_site": "mpit_tpu/serve/shipment.py:313",
        "path": head["body"],
        "launches": (sum(ship_launches.values()) + sum(conv["launches"]["kv_ship"].values())
                     + sum(rec["launches"]["kv_ship"].values())),
        "launches_by_run": {**ship_launches, **conv["launches"]["kv_ship"],
                            **rec["launches"]["kv_ship"]},
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library", "device_ms", "library_device_ms")},
        "shape": {"bytes": head["bytes"], "dtype": head["dtype"]},
    })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)  # the nvidia-smi name and power limit, as it prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
