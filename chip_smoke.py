#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA GPU, and check them.

    python3 chip_smoke.py

Run from the root of the checkout on a machine with an NVIDIA H100 (any
sm_90 card), ``nvcc`` and PyTorch built for CUDA.  Phases, in order; any
failure exits non-zero and no result line is printed:

  1. device   — the card's name and power limit (nvidia-smi), CUDA version;
  2. build    — ``nvcc`` builds ``csrc/sweep_bracket.cu``,
                ``csrc/halo_exchange.cu``, ``csrc/flash_attention_sm90.cu``,
                ``csrc/flash_attention.cu``, ``csrc/mamba_scan.cu``,
                ``csrc/stencil27.cu`` and ``csrc/mamba2_state.cu`` for
                sm_90a, all at once, and logs each one's build time;
  3. kernels  — every CUDA kernel against its plain PyTorch version on the
                card: the sweep kernels (f64 and f32, the reference's test
                shapes) and the halo exchange (bit-exact; 1, 2, 3, 8 and 64
                ranks, each on the "cluster" route where n <= 8 and on the
                "flags" route, f32 and f64, strips read in place from
                blocks with odd and 16-byte plane sizes and from rows whose
                rank stride is no 16-byte multiple; 50 calls in a row per
                route);
  4. pricing  — for each Fig. 7 stencil tile and each HPCG lattice
                (nx = 16, 64, 128, 256; unpack halo buffers): memsim
                ``collect`` -> ``compile_bundle`` -> ``price`` of 262,144
                scenarios under the default plan (the fused kernel on
                "cuda"); the kernel's launch count must rise; the result
                must agree with the "torch" backend on every row and with
                the host "numpy" backend on 16,384 rows (rtol 1e-9), and
                scenario chunking must be bit-identical;
  5. times    — the sweep kernels' device times (profiler; the bracket
                kernel also after an L2 flush and by CUDA events with
                enqueue) beside their plain versions and ``index_add_``;
                ``price_grid_fused`` on 262,144 scenarios at once against
                chunks of 65,536, bit for bit; ``price()`` split into host
                view, H2D, device pricing and D2H, and traced (two traces
                that agree on their device events);
  6. sweeps   — the deployment-scale sweeps through ``price()``, the
                bracket kernel's launches counted around each: the same
                262,144 scenarios from ``adaptive_sample`` (labels equal
                ``ParamGrid.sample``'s; every bundle's result bit-identical;
                the ArraySet's staged split and trace); the ten bundles in
                one multi-bundle call (one launch, resident or tiled route
                logged, within 1e-9 of the single calls; its wall time
                beside theirs); the streaming "distributed:topk=64,refine=1"
                top-k over 524,288 + 524,288 refined scenarios on the tile
                4096 bundle, on 1 and 4 shards (one launch per chunk plus
                the exact pass; indices, speedups and gains of the survivors
                and the aggregates against the fused matrix pricing of every
                scenario; scenarios/s); and ``ExecPlan(x64=False)`` (the
                float32 kernel, within 1e-2 of float64 on gain_ns, and its
                device time);
  7. stencil  — the paper's Fig. 7 decomposition at full size: 8 x 8 ranks
                of 4096^2 f32 tiles, 10 steps with each backend, held
                against ``reference_step`` on the whole 32768^2 plane (atol
                and rtol 1e-6) and bit-identical to each other;
  8. HPCG     — the JAX test's case (4 ranks x 16^3, 30 iterations) on the
                card: converged (max |x - 1| < 1e-2), both backends bit-
                identical and within 1e-4 of the CPU; then 8 ranks x 256^3
                (HPCG validation's largest lattice): ``apply_a`` through
                the operator kernel against ``reference_apply_a`` (rtol
                1e-6, and bit for bit), a 25-iteration PCG with each
                backend, bit-identical, both through the operator kernel
                and the message-free one through the halo kernel (launches
                and routes read from the wrappers: all on the cluster
                route), and one traced solve with each;
                then the halo kernel's device times at the strips of the
                V-cycle's four levels, warm and after an L2 flush, beside
                their bounds, and at level 0 its plain version and two
                ``torch.roll``; then the operator kernel at the four
                levels' slabs (8 ranks, random ghost planes) in float64
                and float32, bit for bit against its plain version, its
                device times beside their bounds, and at level 0 in
                float64 the plain version's;
  8b. Mamba-2 — the Mamba-2 decode state kernel at the granite cell's
                shape (256 slots x 128 heads x 64 x 128, float32, x, B
                and C split from one conv output laid out batch-innermost,
                as the decode's is on the card), held to its plain
                version within the error bounds of
                ``tests/test_torch_mamba2_state.py`` (the share of the new
                state equal bit for bit logged), the given state left
                unwritten, one launch a call; its device time beside its
                bound (the state read and written once) and the plain
                version's;
  9. LM kernels — the flash-attention kernels against their plain version:
                the f32 kernel at the JAX tests' shapes (f32 at 2e-5, three
                block shapes, bf16 at D = 16), the bf16 tensor-core kernel
                at D = 64, 128 and 256 (3e-2, causal and bidirectional with
                T != S, GQA 4:1 and 3:1, B = 2 with a ragged q tile), each
                call's route read from the wrapper's per-route count; and
                the selective-scan kernel at the JAX tests' four shapes
                (1e-4), and over 4,096 steps against a float64
                recurrence (1e-4);
 10. LM forward — ``jamba-v0.1-52b`` at its published widths, cut to one
                pattern period (8 layers: 7 Mamba, 1 attention; MoE on odd
                layers), bf16, weights drawn on the card from a seeded
                generator, ``train_4k`` inputs cut to 2 x 4096 tokens:
                ``forward`` and ``loss`` with the kernels on (1 flash launch,
                on the tensor-core route, and 7 scan launches per forward,
                read from the wrappers; finite
                logits of shape (2, 4096, 65536)); every kernel call of that
                forward held against its plain version on the inputs the
                forward fed it (flash at atol 4e-3 / rtol 1e-2 and a
                relative norm of 2^-7, scan at 1e-4); the same forward with the plain paths, whose
                loss must agree within 1e-2 relative;
 11. LM times  — the flash kernel's device time at the forward's shape
                beside its plain version and ``scaled_dot_product_attention``,
                the flash kernel after an L2 flush and after a GEMM, the
                scan kernel's beside its plain version, the forward's wall
                time (tokens/s), and one traced forward, with the SM clock
                read before and after it and sampled during it (two traces
                that agree on their device events);
 12. serving  — the same model behind the port's engines (kernel launches
                read from the wrappers, every flash and scan call of a
                prefill held against its plain version as in phase 10):
                (a) ``ServeEngine.generate`` of 2 x 1,024-token prompts,
                32 new tokens, ``max_len`` 4,096; (b) ``prefill`` + 32
                ``decode_step``s on those prompts against ``model(batch)``
                over the same tokens (bf16: the relative norm per step
                logged, with the positions an MoE layer of the forward
                routes or drops otherwise; float32, the model converted
                after (f), the MoE capacity raised so that nothing drops:
                relative norm <= 1e-4 per step); (c) the continuous and
                paged engines (8 slots, paged blocks of 16 at the
                dense-equivalent pool) on one Poisson workload (16
                requests at 0.5 a step, prompts of 256-2,048 tokens,
                16-64 new), in turns (continuous, paged, paged,
                continuous), every run's tokens equal; (d) 1 flash launch (on
                the tensor-core route) and 7 scan launches per admission,
                none in decode; then the three engines' ``compiled_steps()``
                captured for phase 13 (no launch; each prefill holds 1 flash
                and 7 scan nodes; flops beside ``analytic.model_flops``;
                ``price`` of each engine 1.0 in every scenario); (e) the
                reduced qwen2.5-3b and jamba in float32, kernels on: greedy
                tokens equal across the three engines; (f) prefill times by
                prompt length, the 8-slot decode step's CUDA-event time and
                trace, and ``run_workload``'s TTFT, latency, tokens/s and KV
                bytes;
 13. advisor  — the advisor on compiled programs: (a) the 8 x 8 x 4096^2
                stencil step (both backends) and the 8 x 256^3 HPCG solve
                (25 iterations) captured with ``core.graph.capture`` under
                fake tensors (the card's allocations grow by less than 1%
                of the apps' working set), their call sites held to the
                JAX package's (the stencil's 4 collective-permutes priced
                by none, HPCG's all-reduces), flops, bytes and the H100
                roofline (each dtype's flops at its peak) beside the times
                phases 7 and 8 measured, and the host cost of a call
                through a custom op against the plain operations; (b) the
                engines' steps of phase 12; (c) all of them, the JAX
                package's synthetic HLO texts and a tensor-parallel step
                under a fake 4-rank process group in ONE ``price()`` under
                the main path's 262,144 scenarios: one bracket launch, held
                against the host "numpy" plan at rtol 1e-9, and per site
                the beneficial share, the ranking by gain and the best
                scenario;
 13b. analysis — the analysis tier (``repro_torch.analysis``) on the card:
                (a) for every case ``kernelcheck`` registers, each CUDA
                source's exported plan (``<entry>_plan``) equal to
                ``ops.plan`` (the card's SM count, the bracket kernel's
                occupancy and the halo flags route's co-resident CTAs read
                from it), within the card's limits, and each kernel
                instantiation's registers, spills, static and dynamic
                shared memory and occupancy (``<entry>_attrs``): registers
                x threads <= 65,536, shared memory <= 227 KB, occupancy >
                0; (b) every kernel and route at a small and a main-path
                shape launched through its raw ``launch*`` into outputs
                between 64 KB guards of sentinel bytes: three launches on
                one fill and one on another bit for bit (every element
                written, none read before it is written), the guards
                untouched, the result against the plain version at the
                kernel's tolerance (no sanitizer runs on the card); (c)
                ``ircheck``'s eight entries captured on the card, their
                findings equal to the host run's, one real call each after
                a warm-up under ``torch.cuda.set_sync_debug_mode("warn")``
                (which sees PyTorch's syncs, not the kernels' ``ctypes``
                launches: a step whose capture saw no host sync and no tensor
                made from host data must raise none) with its memory growth
                beside the capture's peak, and the same for the serve
                phase's model (float32 after serve (b)) in one 8-slot
                decode step; (d) ``repro_torch.lint``, ``kernelcheck``,
                ``dataflow`` and ``ircheck`` as processes on the host, in a
                thread started before phase 13, each exiting 0;
 14. train    — training on the card, whose path runs no kernel (the
                reference's trainer builds its model without them; every
                kernel's count is read around the phase and must stay 0):
                (a) ``qwen2.5-3b`` at its published widths and depth (36
                layers, 3.4 B parameters), bf16, remat on, AdamW with f32
                moments, ``train_4k``'s 4,096-token rows with the batch cut
                to 2, two microbatches (f32 accumulation): each step's
                loss, grad norm and lr, the step time by CUDA events
                (median of steps 2-5), tokens/s, ``model_flops`` per second
                against the 989 TFLOP/s bf16 peak, the peak memory, one
                traced step's busy share and top operations; the loss must
                be finite and fall; (b) every reduced arch (MoE ones with
                dense and scatter) in float32: one step on the card and one
                on the CPU from the same parameters and batch, loss and
                grad norm within 1e-5 relative, the parameters as the CPU
                tests hold them; (c) the reduced qwen2.5-3b and jamba (4
                layers) through ``launch.train.train``: 9 steps, then a run
                failing at step 5 and its restart from the step-3
                checkpoint, the parameters within atol 1e-5; (d) ``python
                -m repro_torch.launch.train --arch qwen2.5-3b --reduced
                --steps 5`` and ``python -m repro_torch.launch.serve --arch
                jamba-v0.1-52b --reduced --paged --price-sweep`` on the
                card, exit 0;
 15. parallel — the parallel layer over ``torch.distributed`` ranks that
                share the card over gloo (NCCL refuses two ranks on one
                GPU; each rank computes on the card, the collectives cross
                host memory, so no time here prices NVLink or NCCL),
                launched through torchrun after the kernels are built
                (``chip_smoke.py --rank world|nccl|probe DIR`` is a rank):
                a probe of which gloo collectives take CUDA tensors (a
                send / receive of one ends the process, so the port stages
                it through host memory); (a) ``jamba-v0.1-52b`` at its
                published widths (8 layers, bf16, 2 x 4096 tokens, kernels
                on) tensor parallel over a (data 1, model 4) mesh of 4
                ranks (attention by query head, mamba by channel, the MLP
                by column, the vocabulary), its MoE layers
                ``moe_impl="ep_local"`` with 4 of the 16 experts each:
                every flash and scan launch of every rank held against its
                plain version as it happens, the launches read from the
                wrappers, the collectives and their bytes counted per
                forward by route, each rank's parameters, forward time and
                peak memory; loss, aux and logits against the whole
                model's scatter forward (bound 3e-2), and the reduced
                jamba in float32 (1e-5); (f) on the same model, TP
                ``prefill`` of 2 x 1,024-token prompts into a 4,096 cache
                (kernels held) and 32 greedy ``decode_step``s, every
                step's logits against the whole model's fed the same
                tokens (3e-2), the greedy tokens that agree, the prefill
                and decode step times per rank; (c) the streaming
                ``"distributed:topk=64,refine=1,devices=4"`` sweep over
                524,288 + 524,288 scenarios on the tile 4096 bundle, a
                shard per rank: 17 bracket launches per rank (each rank's
                first chunk held against the plain pricing), the result
                equal to the stacked 4-shard run's, scenarios/s beside
                it; (d) ``pipeline_apply`` (forward and backward) and
                ``compressed_psum`` on 4 ranks, the card against the CPU;
                (e) the EP-local forward as one NCCL rank (model axis 1),
                bit-identical to scatter; (b) ``python -m
                repro_torch.launch.train`` under torchrun: qwen2.5-3b at
                its published widths cut to 8 layers, bf16, 2 x 4096
                tokens, DP + ZeRO-1 on 2 gloo ranks against 1 rank (losses
                within 1e-3, each rank's moments half), the reduced qwen in
                float32 (1e-6), and the elastic restart (saved on 2 ranks,
                resumed on 1, equal to the uninterrupted run); (g) the
                same launcher tensor parallel on (data 2, model 2), 4
                ranks, against (b)'s one rank (losses within 3e-2, bf16),
                its step, peak and moments per rank; the reduced qwen in
                float32 (1e-5), its checkpoint restored on (4, 1) and
                saved again byte for byte; (h) in the 4-rank world,
                ``launch.dryrun.build_step`` for (g)'s model, batch and
                optimizer on (data 2, model 2) with FSDP on (each rank
                half of (g)'s parameters, gathered where used): 3 steps
                against (g)'s losses (3e-2), the step, parameter, moment
                and peak bytes a rank, and rank 0's collectives of a step
                equal to the step's capture under a fake (2, 2) group in
                this process; (i) in the same world, ``build_step``'s FSDP
                prefill and decode of (a)'s jamba on (2, 2) against the
                TP-only model on the same mesh (teacher-forced, 3e-2; bit
                for bit on the CPU), prefill and decode step times; (j)
                ``python -m repro_torch.launch.dryrun`` over four cells
                on the host beside the ranks (a FSDP ``train_4k``,
                ``llama4-maverick x train_4k`` with Adafactor, a
                ``decode_32k`` and a ``long_500k``, on (16, 16) and (2,
                16, 16)), its time and one line a cell (modelled H100
                terms); no kernel launches in (h)-(j); (k)
                ``layout="fsdp_seq"`` (pure FSDP over every rank, the
                sequence split over ``model``): in this process, before
                the world, flash at q (2, 1,024, 32, 128) against k / v
                (2, 4,096, 8, 128), bf16, ``q_offset`` 3,072 (rank 3's
                block of 4,096 positions over 4 ranks) against its plain
                version and against the whole causal call's rows (bit
                for bit), and the scan over the last 1,024 of 4,096 steps
                (d 8,192, N 16) from a nonzero ``h0`` and the four-block
                two-pass combine against the whole scan, each timed
                beside its bound, plain version and (flash) SDPA with the
                offset's mask; in the world, (a)'s jamba with both
                kernels on (data 1, model 4): one 4,096-token row (1,024
                a rank) prefilled into a 4,352 cache and one greedy
                decode step, every kernel launch held against its plain
                version, no all-reduce, against the whole model on rank 0
                ((f)'s rule: the ranks' routing replayed, the distance to
                float32 within 1.25 x the whole bf16 model's), the tokens
                that agree; (g)'s qwen2.5-3b x 8 trained 3 steps through
                ``build_step(layout="fsdp_seq")`` on (2, 2) against (g)'s
                losses (3e-2), fewer all-reduces a step than layers, its
                collectives equal to a fake (2, 2) capture's; and
                ``python -m repro_torch.launch.perf_cell`` on
                ``qwen2.5-3b x train_4k`` with ``--layout tp`` and
                ``fsdp_seq`` in (j)'s thread;
 16. the ``kernels`` JSON line (the bracket kernel's launches also by
     path, the advisor's among them; the LM kernels' launches of the
     forward and of serving; ``launches_analysis``, the wrappers' launches
     of 13b's real calls; ``launches_train``, 0 for each;
     ``launches_parallel``, the ranks' launches of phase 15, (k)'s
     prefill among them; the LM kernels' (k) rows under ``q_offset`` /
     ``h0``), the nvidia-smi line, and last ``{"ok": true, "device":
     {...}}``.

Exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import importlib
import json
import math
import pathlib
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

S_MAIN = 262_144              # scenarios per price() call (2**18)
S_HOST = 16_384               # rows also priced on the host
CHUNK = 65_536
TILES = (32, 128, 512, 1024, 2048, 4096)     # the paper's Fig. 7 tiles
HPCG_NX = (16, 64, 128, 256)                 # HPCG lattices priced
STENCIL_GRID, STENCIL_TILE, STENCIL_STEPS = (8, 8), 4096, 10   # Fig. 7
HPCG_RANKS, HPCG_NX_FULL, HPCG_ITERS = 8, 256, 25
HPCG_LEVEL_NX = (256, 128, 64, 32)          # the V-cycle's four levels
# the halo kernel's two routes: halo_cluster_kernel and halo_flags_kernel
HALO_KERNEL = "halo_"
OPERATOR_KERNEL = "stencil27_kernel"         # HPCG's 27-point operator
MAMBA2_STATE_KERNEL = "mamba2_state_kernel"  # Mamba-2's decode state update
MAMBA2_CELL = (256, 128, 64, 128, 1)         # granite's (b, H, P, N, G)
TOL_STENCIL = dict(rtol=1e-6, atol=1e-6)     # the JAX test's bound
RTOL_APPLY_A = 1e-6
HALO_RANKS = (1, 2, 3, 8, 64)
HALO_BLOCKS = ((3, 33, 31), (2, 129, 127))   # odd P = ny * nx
HALO_CALLS_IN_A_ROW = 50
RTOL_PATH = 1e-9
DEVICE = "cuda"
LEAD_SPINS = 256              # spin kernels at the start of every trace
TRACE_TRIES = 8
TOL = {"f64": dict(rtol=1e-12, atol=1e-9), "f32": dict(rtol=2e-5, atol=1e-2),
       "segsum": dict(rtol=1e-12, atol=1e-12)}
# Peak rates of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, and float64
# operations/s outside the tensor cores (the kernels' type and unit).
HBM_BYTES_S = 3.35e12
FP64_OPS_S = 34e12
# bf16 operations/s on the tensor cores, float32 operations/s outside them
# (NVIDIA data sheet), and exponentials/s on the special-function units
# (16 per SM per clock on sm_90, CUDA C++ Programming Guide; 132 SMs at the
# 1.98 GHz boost clock).
BF16_OPS_S = 989e12
FP32_OPS_S = 67e12
SFU_EXP_S = 132 * 16 * 1.98e9
LM_ARCH, LM_LAYERS, LM_BATCH, LM_SEED = "jamba-v0.1-52b", 8, 2, 0
RTOL_LM_LOSS = 1e-2
TOL_FLASH = {"f32": dict(rtol=2e-5, atol=2e-5),       # the JAX tests' bounds
             "bf16": dict(rtol=3e-2, atol=3e-2)}
TOL_SCAN = dict(rtol=1e-4, atol=1e-4)
# The flash kernel on the inputs the full-width forward feeds it.  There a
# causal row at position n averages about n / e values of v ~ N(0, 1), so
# most outputs are about sqrt(e / n) ~ 0.03 and the JAX tests' 3e-2 would
# pass them whatever they held: hold them elementwise at 4e-3 (a few times
# one bf16 rounding of such values) and as a whole at bf16's machine epsilon
# of relative norm.
TOL_FLASH_LM = dict(rtol=1e-2, atol=4e-3)
RTOL_NORM_FLASH_LM = 2.0 ** -7
#: (B, S, T, Hq, Hkv, D, causal) and (B, L, d, N): the JAX kernel tests'.
FLASH_CASES = [(1, 128, 128, 4, 4, 64, True), (2, 256, 256, 8, 2, 64, True),
               (1, 256, 256, 16, 16, 128, True),
               (2, 128, 128, 8, 8, 64, False), (1, 384, 384, 6, 2, 64, True)]
FLASH_BLOCKS = ((64, 64), (128, 64), (64, 128))
#: bf16 cases of the tensor-core route at each head width it takes: GQA 3:1
#: causal and 4:1 bidirectional with T != S, B = 2 and S = 192 (a ragged
#: second 128-row q tile).
FLASH_SM90_CASES = [c for D in (64, 128, 256) for c in (
    (2, 192, 192, 6, 2, D, True), (2, 192, 320, 8, 2, D, False))]
SCAN_CASES = [(1, 64, 32, 8), (2, 128, 64, 16), (1, 96, 48, 4),
              (3, 256, 16, 8)]
# the sweeps phase: the streaming seed (2**19 scenarios; one refinement
# round doubles it), its plan, the bundle it prices, and the reference's
# float32 bound on gain_ns (tests/test_execplan.py)
S_STREAM = 524_288
STREAM_PLAN = "distributed:topk=64,refine=1"
STREAM_TOPK, STREAM_TILE, STREAM_DEVICES = 64, 4096, 4
RTOL_F32 = 1e-2
# the serving phase: the static engine's batch, the Poisson workload of the
# continuous and paged engines, their slots, block size and run order,
# the prompt lengths timed, teacher forcing's bounds (bf16: the bound of
# tests/test_torch_models.py test_bf16_forward_with_kernels, logged
# against; float32: the f32 bound of that file, held), and the reduced
# f32 archs whose greedy tokens must agree across the three engines
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 2, 1024, 32, 4096
SERVE_WORKLOAD = dict(n=16, rate=0.5, prompt_len="uniform:256:2048",
                      new_tokens="uniform:16:64", vocab_size=65536, seed=0,
                      max_len=SERVE_MAX_LEN)
SERVE_SLOTS, SERVE_BLOCK = 8, 16
SERVE_TURNS = ("continuous", "paged", "paged", "continuous")
SERVE_PREFILL_LENS = (256, 517, 1024, 2047)
RTOL_NORM_SERVE = 3e-2
RTOL_NORM_SERVE_F32 = 1e-4
SERVE_F32_ARCHS = ("qwen2.5-3b", "jamba-v0.1-52b")
#: The advisor phase: its capture may grow the card's allocations by less
#: than this share of the apps' working set; the fake process group's
#: ranks and the per-rank (tokens, d_model, d_ff / ranks) of its
#: tensor-parallel MLP step; the pricing bound against the host.
ADVISOR_MEM_SHARE = 0.01
ADVISOR_FAKE_RANKS = 4
ADVISOR_TP_SHAPE = (8192, 4096, 14336 // 4)
RTOL_ADVISOR = 1e-9
#: Calls a side of the custom-op dispatch timing makes.
DISPATCH_CALLS = 2000
#: The train phase: (a) qwen2.5-3b at its published widths and depth,
#: bf16, remat on, AdamW, ``train_4k``'s 4,096 tokens a row with the batch
#: cut from 256 to 2, two microbatches; the synthetic task cut to 1
#: template (so the 5 steps see one sequence and the loss can fall: at lr
#: 1e-4 Adam moves a bf16 weight of 0.02 by about one rounding step);
#: steps timed, of which the first is left out; the card's bf16 peak.  (b) every reduced
#: arch in float32, one AdamW step on the card and on the CPU (B 4, S 32,
#: two microbatches): loss and grad norm at TRAIN_RTOL.  (c) the restart
#: check through ``launch.train.train`` (9 steps, failing at 5,
#: checkpoints every 3), held at the reference test's atol.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEED = "qwen2.5-3b", 2, 2, 0
TRAIN_TEMPLATES, TRAIN_STEPS = 1, 5
TRAIN_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=100)
BF16_PEAK_FLOPS = 989e12
TRAIN_SMALL_SHAPE = (32, 4)
TRAIN_RTOL = 1e-5
TRAIN_RESTART = dict(n_steps=9, fail_at=5, every=3, atol=1e-5,
                     archs=(("qwen2.5-3b", {}),
                            ("jamba-v0.1-52b", {"n_layers": 4})))
#: The JAX package's synthetic HLO programs (``tests/test_price.py`` and
#: ``tests/test_sweep.py``), as text: the card has no JAX to compile them.
SYNTH_HLO_A = """
HloModule syntha

ENTRY %main (p0: bf16[1024,1024]) -> bf16[1024,1024] {
  %p0 = bf16[1024,1024]{1,0} parameter(0)
  %ar = bf16[1024,1024]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%add
  ROOT %out = bf16[1024,1024]{1,0} add(%ar, %ar)
}
"""
SYNTH_HLO_B = """
HloModule synthb

ENTRY %main (p0: bf16[512,512]) -> bf16[1024,512] {
  %p0 = bf16[512,512]{1,0} parameter(0)
  %ag = bf16[1024,512]{1,0} all-gather(%p0), replica_groups={{0,1}}, dimensions={0}
  ROOT %out = bf16[1024,512]{1,0} add(%ag, %ag)
}
"""
SYNTH_HLO = """
HloModule synth

ENTRY %main (p0: bf16[1024,1024]) -> bf16[1024,1024] {
  %p0 = bf16[1024,1024]{1,0} parameter(0)
  %ar = bf16[1024,1024]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[2048,1024]{1,0} all-gather(%ar), replica_groups={{0,1}}, dimensions={0}
  ROOT %out = bf16[1024,1024]{1,0} slice(%ag), slice={[0:1024], [0:1024]}
}
"""
BRACKET_CASES = [(1, 1, 4, 0, 3), (3, 5, 40, 17, 29), (16, 3, 128, 128, 128),
                 (7, 130, 200, 150, 90), (2, 4, 0, 0, 0), (2, 3, 640, 10, 5),
                 (0, 3, 10, 5, 2), (4, 0, 0, 0, 0)]


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def trace(torch, fn, reps: int = 1) -> tuple:
    """(device events, wall seconds) of ``reps`` calls of ``fn()`` under
    ``torch.profiler``: the card's kernels and copies, with their names and
    durations.  :data:`LEAD_SPINS` empty spin kernels run first, and are
    left out: the profiler can lose the first device events of a trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if getattr(e, "device_type", None) == cuda_type
            and "spin_kernel" not in e.name], wall


def steady_traces(torch, fn, reps: int = 1, name: str = "",
                  want: int | None = None, count: int = 1) -> list:
    """``count`` results of :func:`trace` that hold the same number of
    device events named ``name`` (``want`` of them, if given).  Besides
    the first events of a trace, the profiler now and then loses others,
    or a whole trace; a trace that lost some would read low.  Raises after
    :data:`TRACE_TRIES` traces."""
    seen, groups = [], {}
    for _ in range(TRACE_TRIES):
        events, wall = trace(torch, fn, reps)
        n = sum(name in e.name for e in events)
        seen.append(n)
        if n and (want is None or n == want):
            group = groups.setdefault(n, [])
            group.append((events, wall))
            if len(group) == count:
                if len(set(seen)) > 1:
                    log(f"trace: the profiler kept {seen} device events "
                        f"named {name!r} in {len(seen)} traces; kept the "
                        f"{count} with {n}")
                return group
    raise RuntimeError(f"the profiler kept {seen} device events named "
                       f"{name!r} in {TRACE_TRIES} traces"
                       + (f", not {want}" if want is not None else ""))


def sm_clock() -> str:
    """The card's SM clock and its maximum, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class ClockSampler:
    """Samples the SM clock (MHz) and power draw (W) every 20 ms with
    ``nvidia-smi -lms`` while the ``with`` block runs; the sampler is
    stopped on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        time.sleep(0.5)               # nvidia-smi's first sample
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.samples = []
        for line in out.splitlines():
            try:
                self.samples.append(tuple(float(f) for f in line.split(",")))
            except ValueError:
                pass
        return False

    def summary(self) -> str:
        if not self.samples:
            return "no samples"
        clk = sorted(c for c, _ in self.samples)
        pwr = sorted(w for _, w in self.samples)
        return (f"{len(clk)} samples: SM clock min {clk[0]:.0f} / median "
                f"{clk[len(clk) // 2]:.0f} / max {clk[-1]:.0f} MHz, power "
                f"median {pwr[len(pwr) // 2]:.1f} / max {pwr[-1]:.1f} W")


def busy_ms(events, name: str = "") -> float:
    """Summed duration in ms of the device events whose name holds
    ``name``."""
    return sum(e.time_range.elapsed_us() for e in events
               if name in e.name) / 1e3


def top_ops(events, n: int) -> list:
    """The ``n`` device operations with the most summed time, as (name,
    ms) pairs."""
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def device_ms(torch, fn, reps: int = 100, name: str = "",
              floor: float = 0.0) -> float:
    """Device time per call of ``fn()`` in ms: the profiler's durations of
    its kernels and copies (of those named ``name``, if given), without the
    host's enqueue time; the median of three traces that agree on the
    count of those events (:func:`steady_traces`).  A reading under
    ``floor`` (the least time the card could take for the work) means the
    traces lost time: they are taken again, up to three times, and the
    last reading is logged as such."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        ms = statistics.median(
            busy_ms(events, name) / reps
            for events, _ in steady_traces(torch, fn, reps, name, count=3))
        if ms >= floor:
            return ms
        log(f"trace: {name or 'the device events'} read {ms:.5f} ms a "
            f"call, under the bound {floor:.5f} ms: the traces lost time")
    return ms


def wall_s(torch, fn, reps: int) -> tuple:
    """(median seconds, last result) of ``fn()`` ending in a synchronize."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def max_abs_err(got: dict, want: dict, tol: dict) -> float:
    """Hold every tensor of ``got`` against ``want`` (raises on a miss)."""
    import numpy as np
    err = 0.0
    for k in want:
        a, b = got[k].cpu().numpy(), want[k].cpu().numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape)
        np.testing.assert_allclose(a, b, err_msg=k, **tol)
        if a.size:
            err = max(err, float(np.max(np.abs(a - b))))
    return err


def rel_diff(np, a, b) -> float:
    """Largest |a - b| / |b| (zeros of ``b`` count as the smallest normal)."""
    tiny = np.finfo(np.float64).tiny
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), tiny)))


def phase_kernels(torch, np, sb):
    """Both kernels against their plain versions at the reference's test
    shapes (f64 and f32 for the fused kernel, unsorted ids for the segment
    sum)."""
    dev = torch.device(DEVICE)
    for dtype, tol in ((torch.float64, TOL["f64"]), (torch.float32, TOL["f32"])):
        for S, n_seg, *ns in BRACKET_CASES:
            rng = np.random.default_rng(S * 100 + sum(ns))
            groups = []
            for n in ns:
                seg = np.sort(rng.integers(0, max(n_seg, 1), size=n))
                groups.append((
                    torch.as_tensor(rng.uniform(1.0, 500.0, n), dtype=dtype,
                                    device=dev),
                    torch.as_tensor(rng.uniform(0.1, 3.0, n), dtype=dtype,
                                    device=dev),
                    torch.as_tensor(seg, dtype=torch.int32, device=dev)))
            d = torch.as_tensor(rng.uniform(-150, 400, (S, 1)), dtype=dtype,
                                device=dev)
            x = torch.as_tensor(rng.uniform(150, 700, (S, 1)), dtype=dtype,
                                device=dev)
            before = sb.fused_bracket_segsum.launches
            out = sb.fused_bracket_segsum(*groups, d, x, n_seg)
            torch.cuda.synchronize()
            launched = sb.fused_bracket_segsum.launches - before
            assert launched == (1 if S and n_seg else 0), (S, n_seg, launched)
            err = max_abs_err(out, sb.bracket_segsum_ref(*groups, d, x, n_seg),
                              tol)
            log(f"kernel fused_bracket_segsum {str(dtype)[6:]} S={S} "
                f"n_seg={n_seg} n={ns}: ok, max_abs_err={err:.3e}")
    rng = np.random.default_rng(5)
    xs = torch.as_tensor(rng.normal(size=(3, 70)), device=dev)
    ids = torch.as_tensor(rng.integers(0, 6, size=70), dtype=torch.int32,
                          device=dev)
    out = sb.segment_sum(xs, ids, 6)
    torch.cuda.synchronize()
    err = max_abs_err({"x": out}, {"x": sb.segment_sum_ref(xs, ids, 6)},
                      TOL["segsum"])
    log(f"kernel segment_sum f64 unsorted ids (3, 70) -> 6: ok, "
        f"max_abs_err={err:.3e}")


def main_path_bundles(ms, stencil, hpcg):
    """(label, bundle) of every Fig. 7 stencil tile, then of every HPCG
    lattice as its validation collects it (unpack halo buffers)."""
    for tile in TILES:
        yield f"stencil tile {tile}", ms.collect(stencil.build_spec(
            stencil.StencilConfig(tile, grid=(8, 8), ranks_per_socket=6)),
            network=ms.NetworkParams.multinode(), seed=0)
    for nx in HPCG_NX:
        cfg = hpcg.HpcgConfig(nx=nx)
        yield f"hpcg nx {nx}", ms.collect(
            hpcg.build_spec(cfg), network=hpcg.validation.NETWORK, seed=0,
            bw_share=cfg.bw_share, ranks_per_socket=cfg.ranks_per_socket)


def phase_main_path(torch, np, pt, ms, sb, stencil, hpcg):
    """Price every Fig. 7 tile's bundle and every HPCG bundle under 262,144
    scenarios on the card and hold the result against the torch and numpy
    backends."""
    t0 = time.perf_counter()
    grid = pt.ParamGrid.sample(pt.ModelParams.multinode(), S_MAIN, seed=0,
                               cxl_lat_ns=(250, 700),
                               cxl_atomic_lat_ns=(300, 800))
    log(f"main: ParamGrid.sample({S_MAIN}) {time.perf_counter() - t0:.3f} s")
    rows = np.sort(np.random.default_rng(1).choice(S_MAIN, S_HOST,
                                                   replace=False))
    host_grid = grid.subset(rows)
    launches = {"fused_bracket_segsum": 0, "segment_sum": 0}
    bundles, results = {}, {}
    for label, bundle in main_path_bundles(ms, stencil, hpcg):
        cb = pt.compile_bundle(bundle)
        bundles[label] = (bundle, cb)

        sb.fused_bracket_segsum.launches = 0
        sb.segment_sum.launches = 0
        t0 = time.perf_counter()
        res = pt.price(cb, grid)                 # the default plan
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_fused = sb.fused_bracket_segsum.launches
        assert n_fused > 0, f"{label}: the fused kernel never launched"
        launches["fused_bracket_segsum"] += n_fused
        launches["segment_sum"] += sb.segment_sum.launches

        for f in pt.MATRIX_FIELDS:
            m = getattr(res, f)
            assert m.shape == (S_MAIN, cb.n_calls) and np.isfinite(m).all(), f
        sp = res.predicted_speedup()
        assert np.isfinite(sp).all() and (sp > 0).all()
        results[label] = res

        unf = pt.price(cb, grid, plan=pt.ExecPlan("torch"))
        worst_t = 0.0
        for f in pt.MATRIX_FIELDS:
            a, b = getattr(res, f), getattr(unf, f)
            np.testing.assert_allclose(a, b, rtol=RTOL_PATH, atol=0,
                                       err_msg=f"torch {f}")
            worst_t = max(worst_t, rel_diff(np, a, b))
        host = pt.price(cb, host_grid, plan="numpy")
        worst_h = 0.0
        for f in pt.MATRIX_FIELDS:
            a, b = getattr(res, f)[rows], getattr(host, f)
            np.testing.assert_allclose(a, b, rtol=RTOL_PATH, atol=0,
                                       err_msg=f"numpy {f}")
            worst_h = max(worst_h, rel_diff(np, a, b))
        np.testing.assert_allclose(sp[rows], host.predicted_speedup(),
                                   rtol=RTOL_PATH, atol=0)
        chunked = pt.price(cb, grid, plan=pt.ExecPlan(
            "fused", chunk_scenarios=CHUNK))
        for f in pt.MATRIX_FIELDS:
            assert np.array_equal(getattr(chunked, f), getattr(res, f)), f
        for i in rows[:3]:
            run = pt.predict_run(bundle, grid.params[i])
            for cid, call in res.scenario_calls(int(i)).items():
                np.testing.assert_allclose(call.t_access_cxl_ns,
                                           run.calls[cid].t_access_cxl_ns,
                                           rtol=RTOL_PATH)
        log(f"main: {label}: {cb.n_calls} sites, samples hit/lfb/miss "
            f"{len(cb.hit_lat)}/{len(cb.lfb_lat)}/{len(cb.miss_lat)}; "
            f"price() {dt:.3f} s, fused launches {n_fused}; speedup "
            f"min/median/max {sp.min():.6f}/{np.median(sp):.6f}/"
            f"{sp.max():.6f}; max rel diff vs torch {worst_t:.3e}, vs numpy "
            f"({S_HOST} rows) {worst_h:.3e}; chunk={CHUNK} bit-identical")
    return grid, bundles, results, launches


def phase_times(torch, np, pt, sb, grid, bundles, card):
    """Kernel, plain-version and library times at the main path's shapes,
    and the split of one price() call."""
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.core.sweep_kernel import price_grid_fused

    dev = torch.device(DEVICE)
    tile = TILES[-1]
    bundle, cb = bundles[f"stencil tile {tile}"]
    view = sweep_mod._scenario_view(grid).to(dev)
    delta = view.cxl_lat_ns - view.mem_lat_ns
    cxl = view.cxl_lat_ns
    t = cb.tensors(dev)
    g = t.groups
    S, C = len(grid), cb.n_calls
    nh, nl, nm = len(cb.hit_lat), len(cb.lfb_lat), len(cb.miss_lat)

    # kernel 1 at the main path's shape, against its plain version
    fused = lambda: sb.fused_bracket_segsum(g["hit"], g["lfb"], g["miss"],
                                            delta, cxl, C)
    plain = lambda: sb.bracket_segsum_ref(
        *[(gg.lat, gg.w, gg.seg) for gg in (g["hit"], g["lfb"], g["miss"])],
        delta, cxl, C)
    err1 = max_abs_err(fused(), plain(), TOL["f64"])
    # device time (the profiler's, no host enqueue), warm and right after
    # 128 MB of writes (which evict the 50 MB L2); CUDA events around one
    # call (enqueue included) beside it
    k1_bytes = 16 * (nh + nl + nm) + 3 * 4 * (C + 1) + 16 * S + 4 * 8 * S * C
    k1_ops = S * (4 * nh + 8 * nl + 4 * nm + 1)
    k1_bound = max(k1_bytes / HBM_BYTES_S, k1_ops / FP64_OPS_S) * 1e3
    k1_by = "bytes" if k1_bytes / HBM_BYTES_S >= k1_ops / FP64_OPS_S \
        else "operations"
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    k1_ms = device_ms(torch, fused, name="bracket_kernel", floor=k1_bound)
    k1_cold = device_ms(torch, lambda: (flush.zero_(), fused()), reps=50,
                        name="bracket_kernel", floor=k1_bound)
    k1_enqueue = cuda_ms(torch, fused)
    k1_plain = device_ms(torch, plain, reps=10, floor=k1_bound)

    # kernel 2 where the unfused sweep would call it: the (S, n_hit) terms
    x = (t.hit_w * torch.maximum(t.hit_lat + delta, delta.new_zeros(())))
    seg = t.hit_seg
    k2 = lambda: sb.segment_sum(x, seg, C)
    plain2 = lambda: sb.segment_sum_ref(x, seg, C)
    out_lib = torch.zeros((S, C), dtype=x.dtype, device=dev)
    lib2 = lambda: out_lib.index_add_(1, seg, x)
    err2 = max_abs_err({"x": k2()}, {"x": plain2()}, TOL["segsum"])
    k2_bytes = 8 * S * nh + 8 * nh + 8 * S * C
    k2_ops = S * nh
    k2_bound = max(k2_bytes / HBM_BYTES_S, k2_ops / FP64_OPS_S) * 1e3
    k2_by = "bytes" if k2_bytes / HBM_BYTES_S >= k2_ops / FP64_OPS_S \
        else "operations"
    k2_ms = device_ms(torch, k2, reps=20, name="segsum_kernel",
                      floor=k2_bound)
    k2_plain = device_ms(torch, plain2, reps=10, floor=k2_bound)
    k2_lib = device_ms(torch, lib2, reps=10, floor=k2_bound)

    log(f"time [{card}]: fused_bracket_segsum S={S} n_seg={C} "
        f"n={nh}/{nl}/{nm}, device time per call (profiler): bracket_kernel "
        f"{k1_ms:.5f} ms (after an L2 flush {k1_cold:.5f} ms), plain "
        f"{k1_plain:.4f} ms; with enqueue (CUDA events, one call) "
        f"{k1_enqueue:.4f} ms; bound {k1_bound:.5f} ms ({k1_by})")
    log(f"time [{card}]: segment_sum ({S}, {nh}) -> {C}, device time per "
        f"call (profiler): segsum_kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain:.4f} ms, index_add_ {k2_lib:.4f} ms, bound "
        f"{k2_bound:.4f} ms ({k2_by})")

    # scenario chunking is bit-identical on the device: the fused pricing
    # of all S scenarios at once against the same scenarios in chunks
    whole = sweep_mod._finalize(price_grid_fused(cb, view), S, C)
    parts = [sweep_mod._finalize(price_grid_fused(cb, view._slice(sl)),
                                 sl.stop - sl.start, C)
             for sl in (slice(i, min(i + CHUNK, S))
                        for i in range(0, S, CHUNK))]
    for f in pt.MATRIX_FIELDS:
        assert np.array_equal(np.concatenate([q[f] for q in parts]),
                              whole[f]), f
    log(f"kernel fused_bracket_segsum: price_grid_fused of {S} scenarios at "
        f"once and in {len(parts)} chunks of {CHUNK}: bit-identical")

    # one price() call, split into its layers
    host_view_s, hview = wall_s(torch, lambda: sweep_mod._scenario_view(grid),
                                3)
    h2d_s, dview = wall_s(torch, lambda: hview.to(dev), 5)
    dev_ms = cuda_ms(torch, lambda: price_grid_fused(cb, dview), reps=10)
    mats = price_grid_fused(cb, dview)
    d2h_s, _ = wall_s(torch, lambda: sweep_mod._finalize(mats, S, C), 5)
    total_s, _ = wall_s(torch, lambda: pt.price(cb, grid), 3)
    log(f"time [{card}]: price() tile {tile} S={S}: total {total_s:.4f} s = "
        f"{S / total_s:.1f} scenarios/s; host view {host_view_s:.4f} s, "
        f"H2D {h2d_s * 1e3:.3f} ms, device pricing {dev_ms:.4f} ms (kernel "
        f"{k1_ms:.4f} ms), D2H {d2h_s * 1e3:.3f} ms")
    phase_price_split(torch, pt, sweep_mod, price_grid_fused, grid, cb, card,
                      "ParamGrid")
    return [
        dict(name="fused_bracket_segsum", route="cuda",
             source="src/repro_torch/kernels/sweep_bracket/csrc/sweep_bracket.cu",
             replaces="src/repro/kernels/sweep_bracket/sweep_bracket.py:68",
             launches=None, max_abs_err=err1, ms=k1_ms, plain_ms=k1_plain,
             bound_ms=k1_bound, bound_by=k1_by, library_ms=None),
        dict(name="segment_sum", route="cuda",
             source="src/repro_torch/kernels/sweep_bracket/csrc/sweep_bracket.cu",
             replaces="src/repro/kernels/sweep_bracket/sweep_bracket.py:151",
             launches=None, max_abs_err=err2, ms=k2_ms, plain_ms=k2_plain,
             bound_ms=k2_bound, bound_by=k2_by, library_ms=k2_lib),
    ]


def timed(torch, stages: dict, name: str, fn):
    """``fn()`` ending in a synchronize; its wall seconds go to
    ``stages[name]``."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    stages[name] = time.perf_counter() - t0
    return out


def phase_price_split(torch, pt, sweep_mod, price_grid_fused, grid, cb,
                      card, label):
    """One price() call over ``grid`` (a ParamGrid or an ArraySet, named by
    ``label``) taken apart in sequence, so that its stages add up to the
    staged total, and a profiler trace of a whole price() call for the
    card's busy time (kernels and copies) against the call's wall time: the
    second of two traces that agree on their count of device events, with
    the bracket kernel in it (raises after :data:`TRACE_TRIES`)."""
    dev = torch.device(DEVICE)
    S, C = len(grid), cb.n_calls
    stages = {}
    stage = lambda name, fn: timed(torch, stages, name, fn)
    for _ in range(2):                     # the second pass is the one kept
        stages.clear()
        v = stage("host view", lambda: sweep_mod._scenario_view(grid))
        dv = stage("H2D", lambda: v.to(dev))
        mats = stage("device pricing", lambda: price_grid_fused(cb, dv))
        host = stage("D2H", lambda: sweep_mod._finalize(mats, S, C))
        stage("result", lambda: pt.SweepResult(grid=grid, compiled=cb, **host))
    staged = sum(stages.values())
    total_s, _ = wall_s(torch, lambda: pt.price(cb, grid), 1)
    log(f"time [{card}]: price() {label} staged: " + ", ".join(
        f"{k} {s * 1e3:.3f} ms ({100 * s / staged:.1f}%)"
        for k, s in stages.items())
        + f"; staged sum {staged * 1e3:.3f} ms, price() right after "
        f"{total_s * 1e3:.3f} ms")

    dev_events, traced_s = steady_traces(torch, lambda: pt.price(cb, grid),
                                         count=2)[-1]
    n_kernel = sum("bracket_kernel" in e.name for e in dev_events)
    assert n_kernel == 1, f"the price() trace holds {n_kernel} bracket kernels"
    busy = busy_ms(dev_events)
    log(f"time [{card}]: price() {label} traced (torch.profiler): wall "
        f"{traced_s * 1e3:.3f} ms, {len(dev_events)} device events "
        f"(kernels and copies, two traces agreeing) busy {busy:.3f} ms = "
        f"{100 * busy / (traced_s * 1e3):.2f}% of the call; idle "
        f"{100 - 100 * busy / (traced_s * 1e3):.2f}%")
    return stages


def traced_share(torch, fn, card, label) -> float:
    """The card's busy share (%) of one call of ``fn`` under the profiler
    (the second of two traces that agree on their device events), logged
    with the call's top device operations."""
    events, wall = steady_traces(torch, fn, count=2)[-1]
    busy = busy_ms(events)
    share = 100 * busy / (wall * 1e3)
    log(f"time [{card}]: {label} traced (torch.profiler, two traces "
        f"agreeing): wall {wall * 1e3:.3f} ms, {len(events)} device events "
        f"busy {busy:.3f} ms = {share:.2f}%; idle {100 - share:.2f}%; top "
        f"device operations: " + "; ".join(
            f"{name[:56]} {ms:.3f} ms" for name, ms in top_ops(events, 5)))
    return share


def stream_split(torch, np, sweep_mod, sk, cb, seed, card) -> dict:
    """The streaming call's steps taken apart on its first chunk: the
    chunk's view and H2D, its pricing alone, its pricing with the on-card
    reduction and the copy back (``price_topk_chunk``), and one refinement
    round's host-side re-sampling; the second of two passes."""
    dev = torch.device(DEVICE)
    n = sk.DIST_CHUNK_DEFAULT
    view = sweep_mod._scenario_view(seed)
    valid, idx = np.ones(n, dtype=bool), np.arange(n)
    points = [seed.label_at(i) for i in range(2 * STREAM_TOPK)]
    stages = {}
    stage = lambda name, fn: timed(torch, stages, name, fn)
    for _ in range(2):
        stages.clear()
        vs = stage("chunk view + H2D", lambda: view._slice(slice(0, n))
                   ._pad(n).to(dev))
        stage("chunk pricing", lambda: sk.price_grid_fused(cb, vs))
        stage("chunk pricing + reduction + D2H", lambda: sk.price_topk_chunk(
            cb, vs, valid, idx, STREAM_TOPK))
        stage("refine round", lambda: seed.refine(points, len(seed), seed=1))
    log(f"time [{card}]: streaming steps (chunk of {n}): " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in stages.items()))
    return dict(stages)


def phase_sweeps(torch, np, pt, sb, grid, bundles, results, card):
    """The deployment-scale sweeps, each through ``price()`` on the card
    with the bracket kernel's launches counted from 0 around it: (a) the
    main path's scenarios as an ArraySet, bit for bit the ParamGrid's
    result for every bundle; (b) the ten bundles in one multi-bundle call,
    within 1e-9 of the single calls; (c) the streaming top-k over
    1,048,576 scenarios on 1 and 4 shards, against the fused matrix
    pricing of the same scenarios; (d) a float32 plan, within 1e-2 of
    float64.  Returns the launches per path and the bracket kernel's
    times on the new shapes."""
    from repro_torch.core import sweep as sweep_mod
    from repro_torch.core import sweep_kernel as sk
    from repro_torch.kernels.sweep_bracket.ops import bracket_resident

    dev = torch.device(DEVICE)
    fused = sb.fused_bracket_segsum
    launches, times = {}, {}
    ranges = dict(cxl_lat_ns=(250, 700), cxl_atomic_lat_ns=(300, 800))

    # (a) the main path's 262,144 scenarios as columns
    t0 = time.perf_counter()
    aset = pt.adaptive_sample(pt.ModelParams.multinode(), S_MAIN, seed=0,
                              **ranges)
    sample_s = time.perf_counter() - t0
    assert aset.labels() == grid.labels(), "adaptive_sample != sample"
    fused.launches = 0
    for label, (_, cb) in bundles.items():
        res = pt.price(cb, aset)
        for f in pt.MATRIX_FIELDS:
            assert np.array_equal(getattr(res, f),
                                  getattr(results[label], f)), (label, f)
    launches["price ArraySet"] = fused.launches
    assert fused.launches == len(bundles), fused.launches
    log(f"sweeps: adaptive_sample({S_MAIN}) {sample_s:.4f} s, labels equal "
        f"ParamGrid.sample's; price() of the ArraySet bit-identical to the "
        f"ParamGrid's for all {len(bundles)} bundles; bracket launches "
        f"{launches['price ArraySet']}")
    cb = bundles[f"stencil tile {STREAM_TILE}"][1]
    times["ArraySet staged"] = phase_price_split(
        torch, pt, sweep_mod, sk.price_grid_fused, aset, cb, card,
        "ArraySet")

    # (b) the ten bundles in one call: one super-bundle, one launch
    labels = list(bundles)
    cbs = [bundles[label][1] for label in labels]
    sup = pt.concat_bundles(cbs)
    groups = sup.tensors(dev).groups
    route = "resident" if bracket_resident(groups.values()) else "tiled"
    fused.launches = 0
    t0 = time.perf_counter()
    multi = pt.price(cbs, grid)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches["multi-bundle"] = fused.launches
    assert fused.launches == 1, fused.launches
    worst = 0.0
    for label, r in zip(labels, multi):
        for f in pt.MATRIX_FIELDS:
            a, b = getattr(r, f), getattr(results[label], f)
            np.testing.assert_allclose(a, b, rtol=RTOL_PATH, atol=0,
                                       err_msg=f"{label} {f}")
            worst = max(worst, rel_diff(np, a, b))
    # in turns (multi, singles, ...), counting the segments the caching
    # allocator took from CUDA (cudaMalloc) during each multi call; then three
    # multi calls back to back
    segments = lambda: torch.cuda.memory_stats().get("segment.all.allocated",
                                                     0)
    multi_t, single_t, new_segments = [], [], []
    for _ in range(3):
        before = segments()
        multi_t.append(wall_s(torch, lambda: pt.price(cbs, aset), 1)[0])
        new_segments.append(segments() - before)
        single_t.append(sum(wall_s(torch, lambda cb=cb: pt.price(cb, aset),
                                   1)[0] for cb in cbs))
    back_t = [wall_s(torch, lambda: pt.price(cbs, aset), 1)[0]
              for _ in range(3)]
    multi_s = statistics.median(multi_t)
    single_s = statistics.median(single_t)
    view = sweep_mod._scenario_view(aset).to(dev)
    delta, cxl = view.cxl_lat_ns - view.mem_lat_ns, view.cxl_lat_ns
    call = lambda: fused(groups["hit"], groups["lfb"], groups["miss"], delta,
                         cxl, sup.n_calls)
    err = max_abs_err(call(), sb.bracket_segsum_ref(
        *[(g.lat, g.w, g.seg) for g in groups.values()], delta, cxl,
        sup.n_calls), TOL["f64"])
    times["multi kernel"] = device_ms(torch, call, reps=20,
                                      name="bracket_kernel")
    times["multi wall"], times["singles wall"] = multi_s, single_s
    times["multi busy"] = traced_share(torch, lambda: pt.price(cbs, aset),
                                       card, "multi-bundle price() of the "
                                       "ArraySet")
    log(f"sweeps: price() of the {len(cbs)} bundles in one call: "
        f"{sup.n_calls} sites, samples hit/lfb/miss {len(sup.hit_lat)}/"
        f"{len(sup.lfb_lat)}/{len(sup.miss_lat)}, bracket route {route}, "
        f"launches {launches['multi-bundle']}; max rel diff vs the single "
        f"calls {worst:.3e} (rtol {RTOL_PATH}); first call (ParamGrid) "
        f"{first_s:.4f} s")
    turns = lambda ts: ", ".join(f"{t:.4f}" for t in ts)
    log(f"time [{card}]: multi-bundle price() of the ArraySet {multi_s:.4f} "
        f"s (median of 3, in turns: {turns(multi_t)}) against "
        f"{single_s:.4f} s for the {len(cbs)} single calls "
        f"({turns(single_t)}); new allocator segments in each multi call "
        f"{new_segments}; multi back to back {turns(back_t)} s; "
        f"bracket_kernel on the super-bundle ({route}, "
        f"S={S_MAIN}, n_seg={sup.n_calls}) {times['multi kernel']:.5f} ms "
        f"device time (profiler), max_abs_err vs plain {err:.3e}")

    # (c) the streaming top-k: 524,288 seed scenarios + one refined round
    seed = pt.adaptive_sample(pt.ModelParams.multinode(), S_STREAM, seed=1,
                              mpi_transfer=["hockney", "loggp"], **ranges)
    n_chunks = 2 * -(-S_STREAM // sk.DIST_CHUNK_DEFAULT)
    runs = {}
    for devices in (1, STREAM_DEVICES):
        plan = STREAM_PLAN + (f",devices={devices}" if devices > 1 else "")
        fused.launches = 0
        t0 = time.perf_counter()
        res = pt.price(cb, seed, plan=plan)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[f"streaming devices={devices}"] = fused.launches
        assert fused.launches == n_chunks + 1, (devices, fused.launches)
        assert len(res.scenarios) == 2 * S_STREAM == res.aggregates.count
        assert res.shard_rows == sk.DIST_CHUNK_DEFAULT // devices, \
            res.shard_rows
        assert len(res) == STREAM_TOPK
        runs[devices] = res
        times[f"streaming devices={devices}"] = dt
        log(f"time [{card}]: price(plan={plan!r}) over "
            f"{len(res.scenarios)} scenarios: {dt:.4f} s = "
            f"{len(res.scenarios) / dt:.1f} scenarios/s; bracket launches "
            f"{fused.launches} ({n_chunks} chunks + the exact pass), "
            f"shard_rows {res.shard_rows}")
    times["streaming busy"] = traced_share(
        torch, lambda: pt.price(cb, seed, plan=STREAM_PLAN), card,
        f"price(plan={STREAM_PLAN!r})")
    times["streaming staged"] = stream_split(torch, np, sweep_mod, sk, cb,
                                             seed, card)
    res = runs[1]
    t0 = time.perf_counter()
    full = pt.price(cb, res.scenarios)
    full_s = time.perf_counter() - t0
    sp = full.predicted_speedup()
    want = full.topk(STREAM_TOPK)
    assert np.array_equal(np.sort(res.indices), np.sort(want))
    np.testing.assert_allclose(res.speedups, sp[res.indices], rtol=RTOL_PATH,
                               atol=0)
    np.testing.assert_allclose(res.result.gain_ns, full.gain_ns[res.indices],
                               rtol=RTOL_PATH, atol=0)
    agg, ragg = res.aggregates, pt.SweepAggregates.from_result(full)
    assert agg.count == ragg.count
    assert np.array_equal(agg.hist, ragg.hist)
    assert np.array_equal(agg.n_beneficial, ragg.n_beneficial)
    np.testing.assert_allclose(
        [agg.speedup_mean, agg.speedup_min, agg.speedup_max],
        [ragg.speedup_mean, ragg.speedup_min, ragg.speedup_max],
        rtol=RTOL_PATH)
    np.testing.assert_allclose(agg.gain_sum, ragg.gain_sum, rtol=RTOL_PATH)
    r4 = runs[STREAM_DEVICES]
    assert np.array_equal(r4.indices, res.indices)
    for k, col in res.scenarios.columns.items():
        assert np.array_equal(r4.scenarios.columns[k], col), k
    log(f"sweeps: streaming top-{STREAM_TOPK} against the fused matrix "
        f"pricing of all {len(res.scenarios)} scenarios ({full_s:.3f} s): "
        f"indices equal as sets, in the same order "
        f"{np.array_equal(res.indices, want)}; speedups {res.speedups[0]:.6f}"
        f"..{res.speedups[-1]:.6f}; hist and n_beneficial exact; "
        f"{STREAM_DEVICES} shards: the same refined scenarios and indices")

    # (d) float32 pricing: the kernel's float instantiation
    plan32 = pt.ExecPlan(x64=False)
    label = f"stencil tile {STREAM_TILE}"
    seen = []

    def wrapped(*args):              # the dtype the wrapper is handed
        seen.append(args[3].dtype)
        return fused(*args)

    sk.fused_bracket_segsum, kept = wrapped, sk.fused_bracket_segsum
    try:
        fused.launches = 0
        f32 = pt.price(cb, grid, plan=plan32)
        torch.cuda.synchronize()
        launches["price x64=0"] = fused.launches
    finally:
        sk.fused_bracket_segsum = kept
    assert fused.launches == 1 and seen == [torch.float32], (fused.launches,
                                                              seen)
    ref64 = results[label].gain_ns
    err32 = float(np.max(np.abs(f32.gain_ns - ref64)
                         / np.maximum(np.abs(ref64), 1.0)))
    assert err32 < RTOL_F32, err32
    v32 = sweep_mod._scenario_view(aset).to(dev, torch.float32)
    g32 = cb.tensors(dev, torch.float32).groups
    d32, x32 = v32.cxl_lat_ns - v32.mem_lat_ns, v32.cxl_lat_ns
    times["f32 kernel"] = device_ms(
        torch, lambda: fused(g32["hit"], g32["lfb"], g32["miss"], d32, x32,
                             cb.n_calls), name="bracket_kernel")
    events, _ = steady_traces(torch, lambda: pt.price(cb, aset, plan=plan32),
                              name="bracket_kernel", want=1)[0]
    names = sorted({e.name for e in events if "bracket_kernel" in e.name})
    times["f32 price"], _ = wall_s(torch, lambda: pt.price(cb, aset,
                                                           plan=plan32), 3)
    times["f64 price"], _ = wall_s(torch, lambda: pt.price(cb, aset), 3)
    log(f"sweeps: price(x64=False) tile {STREAM_TILE}: bracket launches "
        f"{launches['price x64=0']} on float32 inputs, kernel {names}; max "
        f"|gain_ns f32 - f64| / max(|f64|, 1) {err32:.3e} (bound {RTOL_F32})")
    log(f"time [{card}]: bracket_kernel float32 S={S_MAIN} n_seg="
        f"{cb.n_calls} {times['f32 kernel']:.5f} ms device time (profiler); "
        f"price() of the ArraySet float32 {times['f32 price']:.4f} s, "
        f"float64 {times['f64 price']:.4f} s (medians of 3)")
    return launches, times


def halo_layouts(torch, np, n, dtype, seed):
    """(label, strip_lo, strip_hi) read in place: from (n, nz, ny, nx)
    blocks with odd plane sizes, from blocks whose planes are 16-byte
    multiples (the kernel's 16-byte units), and from rows of a wider array
    whose rank stride is no 16-byte multiple."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    out = []
    for shape in HALO_BLOCKS + ((2, 64, 48),):
        b = torch.as_tensor(rng.normal(size=(n, *shape)), dtype=dtype,
                            device=dev)
        out.append((f"blocks {shape}", b[:, 0], b[:, -1]))
    t = torch.as_tensor(rng.normal(size=(n, 3, 4097)), dtype=dtype,
                        device=dev)
    out.append(("rank stride 12291", t[:, 0, :4096], t[:, 1, 1:]))
    return out


def phase_halo_kernel(torch, np, hx):
    """The halo kernel against its plain version, bit for bit: every rank
    count, layout and dtype on each route that takes it, then many calls in
    a row on one stream per route."""
    for dtype in (torch.float32, torch.float64):
        for n in HALO_RANKS:
            routes = [r for r in hx.ROUTES
                      if r != "cluster" or n <= hx.CLUSTER_MAX]
            for label, lo, hi in halo_layouts(torch, np, n, dtype, n * 7):
                want = hx.ring_halo_exchange_ref(lo, hi)
                for route in routes:
                    before = dict(hx.ring_halo_exchange.route_launches)
                    got = hx.ring_halo_exchange(lo, hi, route=route)
                    torch.cuda.synchronize()
                    after = hx.ring_halo_exchange.route_launches
                    assert after[route] == before[route] + 1, route
                    for g, w in zip(got, want):
                        assert g.dtype == dtype and torch.equal(g, w), \
                            (n, label, route)
                log(f"kernel ring_halo_exchange {str(dtype)[6:]} n={n} "
                    f"{label} (P={lo[0].numel()}, in place), routes "
                    f"{'/'.join(routes)}: bit-exact")
    for route in hx.ROUTES:
        blocks = torch.as_tensor(np.random.default_rng(9).normal(
            size=(8, *HALO_BLOCKS[-1])), dtype=torch.float32, device=DEVICE)
        for i in range(HALO_CALLS_IN_A_ROW):
            blocks = blocks + 1.0
            got = hx.ring_halo_exchange(blocks[:, 0], blocks[:, -1],
                                        route=route)
            want = hx.ring_halo_exchange_ref(blocks[:, 0], blocks[:, -1])
            assert all(torch.equal(g, w) for g, w in zip(got, want)), i
        torch.cuda.synchronize()
        log(f"kernel ring_halo_exchange [{route}]: {HALO_CALLS_IN_A_ROW} "
            f"calls in a row on one stream (n=8): bit-exact")


def device_allclose(torch, a, b, rtol: float, atol: float) -> float:
    """Hold ``a`` against ``b`` on the device (raises on a miss); returns
    max |a - b|."""
    diff = (a - b).abs_()
    err = float(diff.max())
    worst = float(diff.sub_(b.abs().mul_(rtol)).max())
    assert worst <= atol, f"max |a - b| {err:.3e} beyond rtol {rtol} / " \
        f"atol {atol} (excess {worst:.3e})"
    return err


def phase_stencil(torch, grid_mesh, st, card):
    """Fig. 7's 8 x 8 ranks of 4096^2 f32 tiles, 10 steps per backend,
    against ``reference_step`` on the whole plane.  Returns each backend's
    step time (ms)."""
    px, py = STENCIL_GRID
    grid = grid_mesh(px, py)
    H, W = px * STENCIL_TILE, py * STENCIL_TILE
    plane = st.init_plane(H, W)
    step_times = {}
    t0 = time.perf_counter()
    ref = plane
    for _ in range(STENCIL_STEPS):
        ref = st.reference_step(ref)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    outs = {}
    for backend in ("message_based", "message_free"):
        t0 = time.perf_counter()
        out = st.make_runner(grid, backend)(plane, STENCIL_STEPS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        assert out.shape == (H, W) and bool(torch.isfinite(out).all())
        err = device_allclose(torch, out, ref, **TOL_STENCIL)
        step = st.make_step(grid, backend)
        tiles = st.to_tiles(plane, grid)
        step_ms = cuda_ms(torch, lambda: step(tiles), reps=STENCIL_STEPS,
                          warmup=1)
        outs[backend] = out
        step_times[backend] = step_ms
        log(f"stencil [{card}]: {backend} {px}x{py} ranks x "
            f"{STENCIL_TILE}^2 f32, {STENCIL_STEPS} steps: make_runner "
            f"{run_s:.4f} s, step {step_ms:.4f} ms (CUDA events, median of "
            f"{STENCIL_STEPS}); max |x - reference_step^{STENCIL_STEPS}| "
            f"{err:.3e}")
        del tiles
    assert torch.equal(outs["message_based"], outs["message_free"])
    log(f"stencil: message_based and message_free bit-identical; "
        f"reference_step x{STENCIL_STEPS} on the {H}x{W} plane {ref_s:.4f} s")
    del plane, ref, outs
    torch.cuda.empty_cache()
    return step_times


def phase_hpcg_small(torch, grid_mesh, hp):
    """The JAX test's case on the card (4 ranks, 16^3, 30 iterations): both
    backends converge (max |x - 1| < 1e-2), agree bit for bit, and agree
    with the same solve on the CPU (atol 1e-4)."""
    cpu_grid = grid_mesh(4, device="cpu")
    b = hp.make_problem((16, 16, 16), device="cpu")
    want, _ = hp.make_cg(cpu_grid, "message_free", n_iter=30)(
        b, torch.zeros_like(b))
    b = b.to(DEVICE)
    outs = {}
    for backend in ("message_based", "message_free"):
        x, res = hp.make_cg(grid_mesh(4), backend, n_iter=30)(
            b, torch.zeros_like(b))
        err = float((x - 1.0).abs().max())
        cpu_err = float((x.cpu() - want).abs().max())
        assert err < 1e-2 and cpu_err <= 1e-4, (backend, err, cpu_err)
        outs[backend] = (x, res)
        log(f"hpcg: {backend} PCG 30 iterations on 4 ranks x 16^3 (the JAX "
            f"test's case): residual norm {float(res):.6e}, max |x - 1| "
            f"{err:.3e}, max |x - x_cpu| {cpu_err:.3e}")
    (xa, ra), (xb, rb) = outs["message_based"], outs["message_free"]
    assert torch.equal(xa, xb) and torch.equal(ra, rb)


def phase_hpcg(torch, grid_mesh, hp, hx, card):
    """8 ranks x 256^3: apply_a against its oracle (bit for bit, through
    the operator kernel), then the PCG with each backend, then one traced
    solve with each.  Returns the halo kernel's launches in the
    message-free solve, the (8, 256, 256, 256) slabs for the kernel's
    times, and each backend's solve times (s)."""
    from repro_torch.kernels.stencil27 import apply_27pt
    grid = grid_mesh(HPCG_RANKS)
    shape = (HPCG_RANKS * HPCG_NX_FULL, HPCG_NX_FULL, HPCG_NX_FULL)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=DEVICE)
    want = hp.reference_apply_a(x)
    for backend in ("message_based", "message_free"):
        before = apply_27pt.launches
        got = hp.from_slabs(hp.apply_a(hp.to_slabs(x, HPCG_RANKS), backend))
        assert apply_27pt.launches == before + 1, "apply_a never launched " \
            "the operator kernel"
        err = device_allclose(torch, got, want, RTOL_APPLY_A, 0.0)
        # the kernel keeps the plain sum's order: equal bit for bit
        assert torch.equal(got, want), backend
        log(f"hpcg: apply_a {backend} on {HPCG_RANKS} ranks x "
            f"{HPCG_NX_FULL}^3 against reference_apply_a on {shape}: "
            f"max abs err {err:.3e} (rtol {RTOL_APPLY_A}), bit for bit")
    del x, want, got
    b = hp.make_problem(shape)
    b_norm = float(torch.linalg.vector_norm(b))
    solve = {k: hp.make_cg(grid, k, n_iter=HPCG_ITERS)
             for k in ("message_based", "message_free")}
    results, times, launches, routes = {}, {}, 0, {}
    # in turns (based, free, free, based), so that neither backend alone
    # pays the allocator's first growth
    for backend in ("message_based", "message_free", "message_free",
                    "message_based"):
        hx.ring_halo_exchange.launches = 0
        hx.ring_halo_exchange.route_launches = {r: 0 for r in hx.ROUTES}
        n_op = apply_27pt.launches
        t0 = time.perf_counter()
        xs, res = solve[backend](b, torch.zeros_like(b))
        torch.cuda.synchronize()
        times.setdefault(backend, []).append(time.perf_counter() - t0)
        n_launch = hx.ring_halo_exchange.launches
        n_op = apply_27pt.launches - n_op
        # one operator launch an apply_a on either backend, one exchange
        # with it on the message-free one
        assert n_op > 0 and (n_launch in (0, n_op)), (n_op, n_launch)
        if backend == "message_free":
            launches = n_launch
            routes = dict(hx.ring_halo_exchange.route_launches)
            assert launches > 0, "the message-free solve never launched " \
                "the halo kernel"
            # HPCG's ring of 8 takes the cluster route, every launch
            assert routes == {"cluster": launches, "flags": 0}, routes
        else:
            assert n_launch == 0, n_launch
        assert xs.shape == shape and bool(torch.isfinite(xs).all())
        assert 0 < float(res) < b_norm, (float(res), b_norm)
        if backend in results:
            assert torch.equal(xs, results[backend][0]), backend
            continue
        results[backend] = (xs, res)
        log(f"hpcg: {backend} PCG {HPCG_ITERS} iterations on {HPCG_RANKS} "
            f"ranks x {HPCG_NX_FULL}^3 f32: residual norm {float(res):.6e} "
            f"(|b| {b_norm:.6e}), max |x - 1| "
            f"{float((xs - 1.0).abs().max()):.3e}, halo kernel launches "
            f"{n_launch}" + (f" (routes {routes})" if n_launch else "")
            + f", apply_27pt launches {n_op}")
    for backend, ts in times.items():
        log(f"hpcg [{card}]: {backend} solve " + ", ".join(
            f"{t:.4f} s" for t in ts) + " (in turns: based, free, free, "
            "based)")
    (xa, ra), (xb, rb) = results["message_based"], results["message_free"]
    assert torch.equal(xa, xb) and torch.equal(ra, rb)
    log("hpcg: message_based and message_free bit-identical")
    del results, xa, xb

    for backend in ("message_based", "message_free"):
        # a trace that holds every halo launch of the solve; for the
        # message-based solve, two traces that agree on the event count
        events, wall = steady_traces(
            torch, lambda: solve[backend](b, torch.zeros_like(b)),
            **({"name": HALO_KERNEL, "want": launches}
               if backend == "message_free" else {"count": 2}))[-1]
        busy, halo = busy_ms(events), busy_ms(events, HALO_KERNEL)
        n_halo = sum(HALO_KERNEL in e.name for e in events)
        share = 100 * busy / 1e3 / wall
        top = top_ops(events, 4)
        log(f"hpcg [{card}]: {backend} solve traced (torch.profiler): wall "
            f"{wall:.4f} s, {len(events)} device events busy {busy:.3f} ms "
            f"({share:.2f}%; idle {100 - share:.2f}%), {HALO_KERNEL}* "
            f"{n_halo} launches {halo:.3f} ms "
            f"({100 * halo / max(busy, 1e-9):.3f}% of the busy time); top "
            f"kernels: " + "; ".join(
                f"{name[:48]} {ms:.1f} ms" for name, ms in top))
    return launches, hp.to_slabs(b, HPCG_RANKS), times


def phase_halo_times(torch, hx, blocks, card):
    """The halo kernel at the strips of each HPCG level (8 ranks x 256^2,
    128^2, 64^2, 32^2 f32; level 0 read in place from the solve's slabs),
    on its route: device time per call from the profiler (the kernel
    alone), warm and right after 128 MB of writes, beside its bound; at
    level 0 also its plain version and two ``torch.roll`` calls, and the
    CUDA-event time of one call (enqueue included)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=blocks.device)
    gen = torch.Generator(device=blocks.device).manual_seed(1)
    level0 = None
    for level, nx in enumerate(HPCG_LEVEL_NX):
        b = blocks if level == 0 else torch.randn(
            (HPCG_RANKS, nx, nx, nx), generator=gen, device=blocks.device)
        lo, hi = b[:, 0], b[:, -1]
        got = hx.ring_halo_exchange(lo, hi)
        want = hx.ring_halo_exchange_ref(lo, hi)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        assert err == 0.0 and all(torch.equal(g, w)
                                  for g, w in zip(got, want))
        route = hx.route_for(lo.shape[0])
        n, p = lo.shape[0], lo[0].numel()
        nbytes = 4 * n * p * lo.element_size()   # 2 strips read, 2 written
        bound = nbytes / HBM_BYTES_S * 1e3
        warm = device_ms(torch, lambda: hx.ring_halo_exchange(lo, hi),
                         reps=200, name=HALO_KERNEL, floor=bound)
        cold = device_ms(torch, lambda: (flush.zero_(),
                                         hx.ring_halo_exchange(lo, hi)),
                         reps=50, name=HALO_KERNEL, floor=bound)
        log(f"time [{card}]: halo_exchange level {level}, {n} ranks x "
            f"{tuple(lo.shape[1:])} f32 [{route}], device time per call "
            f"(profiler): {warm:.5f} ms, after an L2 flush {cold:.5f} ms; "
            f"bound {bound:.5f} ms (bytes: {nbytes})")
        if level == 0:
            level0 = (lo, hi, err, warm, bound)
        del b
    lo, hi, err, warm, bound = level0
    others = {"plain": lambda: hx.ring_halo_exchange_ref(lo, hi),
              "torch.roll x2": lambda: (torch.roll(hi, 1, 0),
                                        torch.roll(lo, -1, 0))}
    dev = {k: device_ms(torch, fn, floor=bound) for k, fn in others.items()}
    call = cuda_ms(torch, lambda: hx.ring_halo_exchange(lo, hi), reps=100,
                   warmup=10)
    log(f"time [{card}]: halo_exchange level 0, device time per call "
        f"(profiler): " + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
        + f"; the kernel with enqueue (CUDA events) {call:.4f} ms")
    return dict(name="halo_exchange", route="cuda",
                source="src/repro_torch/kernels/halo_exchange/csrc/"
                       "halo_exchange.cu",
                replaces="src/repro/kernels/halo_exchange/halo_exchange.py:33",
                launches=None, max_abs_err=err, ms=warm,
                plain_ms=dev["plain"], bound_ms=bound, bound_by="bytes",
                library_ms=dev["torch.roll x2"])


def phase_operator_times(torch, card):
    """The operator kernel at the slabs of each HPCG level (8 ranks x
    256^3, 128^3, 64^3, 32^3) in float64, the benchmark cell's type, and
    in float32, with random ghost planes: bit for bit against its plain
    version (``apply_27pt_ref`` on the same CUDA tensors), then its device
    time per call (profiler, the kernel alone) beside its bound, the slabs
    and ghost planes read once and ``y`` written once; at level 0 in
    float64 also the plain version's.  Returns the ``kernels`` entry."""
    from repro_torch.kernels.stencil27 import apply_27pt, apply_27pt_ref
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    row = None
    for dtype in (torch.float64, torch.float32):
        for level, nx in enumerate(HPCG_LEVEL_NX):
            x = torch.randn((HPCG_RANKS, nx, nx, nx), generator=gen,
                            dtype=dtype, device=DEVICE)
            below, above = torch.randn((2, HPCG_RANKS, 1, nx, nx),
                                       generator=gen, dtype=dtype,
                                       device=DEVICE).unbind(0)
            before = apply_27pt.launches
            got = apply_27pt(x, below, above)
            assert apply_27pt.launches == before + 1
            assert torch.equal(got, apply_27pt_ref(x, below, above)), \
                (dtype, level)
            del got
            nbytes = (2 * x.numel() + below.numel() + above.numel()) \
                * x.element_size()
            bound = nbytes / HBM_BYTES_S * 1e3
            ms = device_ms(torch, lambda: apply_27pt(x, below, above),
                           reps=50, name=OPERATOR_KERNEL, floor=bound)
            log(f"time [{card}]: stencil27 level {level}, {HPCG_RANKS} ranks "
                f"x {nx}^3 {str(dtype)[6:]}, bit for bit against its plain "
                f"version; device time per call (profiler): {ms:.5f} ms, "
                f"bound {bound:.5f} ms (bytes: {nbytes}; "
                f"{100 * bound / ms:.1f}% of it)")
            if dtype == torch.float64 and level == 0:
                plain = device_ms(torch,
                                  lambda: apply_27pt_ref(x, below, above),
                                  reps=5, floor=bound)
                log(f"time [{card}]: stencil27 level 0 float64, its plain "
                    f"version (cat, pad, 28 operations) {plain:.4f} ms a "
                    f"call; no single PyTorch call computes the operator")
                row = dict(name="stencil27", route="cuda",
                           source="src/repro_torch/kernels/stencil27/csrc/"
                                  "stencil27.cu",
                           replaces=None, launches=None, max_abs_err=0.0,
                           ms=ms, plain_ms=plain, bound_ms=bound,
                           bound_by="bytes", library_ms=None)
            del x, below, above
    torch.cuda.empty_cache()
    return row


def phase_mamba2_state_times(torch, card):
    """The Mamba-2 decode state kernel at the granite cell's shape: held to
    its plain version (``mamba2_state_update_ref`` on the same CUDA
    tensors) within the test's bounds, the given state unwritten, one
    launch a call; then its device time per call (profiler, the kernel
    alone) beside its bound, the state read and written once and x, dt,
    B, C in and y out, and the plain version's."""
    from repro_torch.kernels.mamba2_state import (mamba2_state_update,
                                                  mamba2_state_update_ref)
    b, H, P, N, G = MAMBA2_CELL
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    f32 = dict(dtype=torch.float32, device=DEVICE)
    ssm = torch.randn((b, H, P, N), generator=gen, **f32)
    # x, B and C split from one conv output, batch-innermost as the
    # decode's einsum lays it out on the card
    xs, Bt, Ct = torch.randn((H * P + 2 * G * N, b), generator=gen,
                             **f32).t().split([H * P, G * N, G * N], dim=-1)
    dt = torch.nn.functional.softplus(
        torch.randn((b, H), generator=gen, **f32) - 4.0)
    A_log = torch.log(torch.empty((H,), **f32).uniform_(1.0, 16.0,
                                                        generator=gen))
    D = torch.randn((H,), generator=gen, **f32)
    args = (ssm, xs.reshape(b, H, P), dt, Bt.reshape(b, G, N),
            Ct.reshape(b, G, N), A_log, D)
    before, n0 = ssm.clone(), mamba2_state_update.launches
    y, S = mamba2_state_update(*args)
    torch.cuda.synchronize()
    assert mamba2_state_update.launches == n0 + 1
    assert torch.equal(ssm, before), "the given state was written"
    del before
    same = hold_mamba2_state(torch, args, y, S)
    del y, S
    nbytes = 2 * ssm.numel() * 4 + 4 * b * (2 * H * P + H + 2 * G * N)
    bound = nbytes / HBM_BYTES_S * 1e3
    ms = device_ms(torch, lambda: mamba2_state_update(*args), reps=50,
                   name=MAMBA2_STATE_KERNEL, floor=bound)
    plain = device_ms(torch, lambda: mamba2_state_update_ref(*args), reps=5,
                      floor=bound)
    log(f"time [{card}]: mamba2_state {b} x {H} x {P} x {N} float32, "
        f"within its bounds of the plain version ({100 * same:.4f}% of the "
        f"new state bit for bit); device time per call (profiler): "
        f"{ms:.5f} ms, bound {bound:.5f} ms (bytes: {nbytes}; "
        f"{100 * bound / ms:.1f}% of it); its plain version (11 launches: "
        f"the decay, dt x, the product, addcmul_, a copy of C, the gemv, "
        f"D x) {plain:.4f} ms a call")
    del args, ssm
    torch.cuda.empty_cache()


def hold_mamba2_state(torch, args, y, S) -> float:
    """The Mamba-2 state kernel's ``y`` and new state ``S`` for ``args``
    against its plain version on the same tensors, within the bounds of
    ``tests/test_torch_mamba2_state.py`` (``u = 2^-24``): the state within
    ``6 u (|S da| + |u B|)`` (the kernel's fma), ``y`` within ``2 (N + 3)
    u`` of its terms' magnitudes (the order of its sum).  Raises on a miss;
    returns the share of the new state equal bit for bit."""
    from repro_torch.kernels.mamba2_state import mamba2_state_update_ref
    ssm, x, dt, Bt, Ct, A_log, D = args
    H, N, G = ssm.shape[1], ssm.shape[3], Bt.shape[1]
    heads = torch.arange(H, device=ssm.device) // (H // G)
    y_ref, S_ref = mamba2_state_update_ref(*args)
    u = 2.0 ** -24
    da = torch.exp(dt * -torch.exp(A_log))[..., None, None]
    mag = (ssm * da).abs_().add_(((dt[..., None] * x)[..., None]
                                  * Bt[:, heads, None, :]).abs_())
    same = float((S == S_ref).float().mean())
    err_s = float((S - S_ref).abs_().sub_(mag * (6 * u)).max())
    terms = torch.einsum("bhpn,bhn->bhp", mag, Ct[:, heads].abs()) \
        + (x * D[:, None]).abs()
    err_y = float(((y - y_ref).abs() - terms * (2 * (N + 3) * u)).max())
    assert err_s <= 0.0 and err_y <= 0.0, \
        f"mamba2_state beyond its bounds by {err_s:.3e} / {err_y:.3e}"
    return same


def hold(torch, got, want, tol: dict) -> float:
    """``got`` against ``want`` in float32 on the device (raises on a miss);
    returns max |got - want|."""
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    return device_allclose(torch, got.float(), want.float(), **tol)


def phase_lm_kernels(torch, np, fa, ms):
    """Both LM kernels against their plain versions at the JAX kernel tests'
    shapes."""
    dev = torch.device(DEVICE)

    def qkv(B, S, T, Hq, Hkv, D, dtype, seed):
        rng = np.random.default_rng(seed)
        return [torch.as_tensor(rng.normal(size=shp), dtype=dtype, device=dev)
                for shp in ((B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))]

    runs = [(c, torch.float32, 128, 128) for c in FLASH_CASES]
    runs += [((1, 256, 256, 4, 4, 64, True), torch.float32, bq, bk)
             for bq, bk in FLASH_BLOCKS]
    runs.append(((1, 128, 128, 4, 4, 64, True), torch.bfloat16, 128, 128))
    runs.append(((1, 128, 128, 4, 4, 16, True), torch.bfloat16, 128, 128))
    runs += [(c, torch.bfloat16, c[1], c[2]) for c in FLASH_SM90_CASES]
    for (B, S, T, Hq, Hkv, D, causal), dtype, bq, bk in runs:
        q, k, v = qkv(B, S, T, Hq, Hkv, D, dtype, S + Hq + bq + bk)
        path = fa.route(dtype, D)
        before = fa.flash_attention.launches
        on_route = fa.flash_attention.route_launches[path]
        out = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        assert fa.flash_attention.route_launches[path] == on_route + 1
        tol = TOL_FLASH["f32" if dtype == torch.float32 else "bf16"]
        err = hold(torch, out, fa.attention_ref(q, k, v, causal), tol)
        log(f"kernel flash_attention [{path}] {str(dtype)[6:]} B={B} S={S} "
            f"T={T} Hq={Hq} Hkv={Hkv} D={D} causal={causal} blocks "
            f"{bq}/{bk}: ok, max_abs_err={err:.3e}")

    def scan_inputs(B, L, d, N):
        rng = np.random.default_rng(L + d)
        return [torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
            rng.normal(size=(B, L, d)),
            np.abs(rng.normal(0.05, 0.02, size=(B, L, d))),
            rng.normal(size=(B, L, N)), rng.normal(size=(B, L, N)),
            -np.abs(rng.normal(1, 0.3, size=(d, N))), rng.normal(size=(d,)))]

    for B, L, d, N in SCAN_CASES:
        ins = scan_inputs(B, L, d, N)
        before = ms.mamba_scan.launches
        y, h = ms.mamba_scan(*ins, d_block=d, chunk=L)
        torch.cuda.synchronize()
        assert ms.mamba_scan.launches == before + 1
        yr, hr = ms.mamba_scan_ref(*ins)
        err = max(hold(torch, y, yr, TOL_SCAN), hold(torch, h, hr, TOL_SCAN))
        log(f"kernel mamba_scan f32 B={B} L={L} d={d} N={N}: ok, "
            f"max_abs_err={err:.3e}")
    # Drift over 4,096 steps: the kernel (ex2.approx decays) held against a
    # float64 recurrence.  The float32 plain version is no oracle here: its
    # own rounding over such a run reaches the size of the bound.
    ins = scan_inputs(2, 4096, 256, 16)
    y, _ = ms.mamba_scan(*ins)
    y64, _ = ms.mamba_scan_ref(*(t.double() for t in ins))
    err = hold(torch, y.double(), y64, TOL_SCAN)
    yr, _ = ms.mamba_scan_ref(*ins)
    log(f"kernel mamba_scan f32 B=2 L=4096 d=256 N=16 against a float64 "
        f"recurrence: ok, max_abs_err={err:.3e}; the float32 plain version "
        f"{float((yr.double() - y64).abs().max()):.3e} from it, the kernel "
        f"{float((y - yr).abs().max()):.3e} from the plain version (max |y| "
        f"{float(y64.abs().max()):.2f})")


class _Recorder:
    """Passes each call on to a kernel wrapper and keeps its inputs and
    output; the wrapper itself (and its launch count) is untouched."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


def phase_lm(torch, fa, ms):
    """The LM's full-sequence forward at full width on the card: the main
    path with both kernels, each kernel call held against its plain version,
    and the same forward with the plain paths.  Returns the model, its
    batch, the kernel launches of one forward and the recorded calls."""
    import types
    from repro_torch import configs
    from repro_torch.models import blocks, layers, make_inputs, make_model
    from repro_torch.models import mamba as mamba_mod

    cfg = configs.get_arch(LM_ARCH).replace(n_layers=LM_LAYERS)
    specs = blocks.layer_specs(cfg)
    want = {"flash_attention": sum(s.mixer == "attn" for s in specs),
            "mamba_scan": sum(s.mixer == "mamba" for s in specs)}
    assert want == {"flash_attention": 1, "mamba_scan": 7}, want
    shape = configs.get_shape("train_4k")
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(LM_SEED)
    model = make_model(cfg, use_kernel=True, moe_impl="scatter",
                       device=DEVICE, generator=gen)
    batch = make_inputs(cfg, shape, seed=LM_SEED, batch_override=LM_BATCH,
                        device=DEVICE)
    torch.cuda.synchronize()
    n_params = model.param_count()
    kinds = ", ".join(f"{s.mixer}/{s.ffn}" for s in specs)
    log(f"lm: {cfg.name} x {cfg.n_layers} layers ({kinds}), "
        f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, {cfg.n_experts} experts "
        f"top-{cfg.experts_per_token}, d_inner {cfg.d_inner}, N "
        f"{cfg.ssm_state}, vocab {cfg.vocab_size}, {cfg.dtype}: {n_params:,} "
        f"parameters ({n_params * 2 / 1e9:.2f} GB), active "
        f"{model.active_param_count():,}; weights and batch "
        f"{tuple(batch['tokens'].shape)} in {time.perf_counter() - t0:.2f} s")

    rec = {"flash_attention": _Recorder(fa.flash_attention),
           "mamba_scan": _Recorder(ms.mamba_scan)}
    fa_ops, ms_ops = layers.fa_ops, mamba_mod.ms_ops
    layers.fa_ops = types.SimpleNamespace(
        flash_attention=rec["flash_attention"])
    mamba_mod.ms_ops = types.SimpleNamespace(mamba_scan=rec["mamba_scan"])
    try:
        with torch.inference_mode():
            fa.flash_attention.launches = 0
            fa.flash_attention.route_launches = {"sm90": 0, "simt": 0}
            ms.mamba_scan.launches = 0
            t0 = time.perf_counter()
            logits, aux = model(batch)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            launches = {"flash_attention": fa.flash_attention.launches,
                        "mamba_scan": ms.mamba_scan.launches}
            routes = dict(fa.flash_attention.route_launches)
    finally:
        layers.fa_ops, mamba_mod.ms_ops = fa_ops, ms_ops
    assert launches == want, launches
    # the forward's attention took the bf16 tensor-core kernel
    assert routes == {"sm90": want["flash_attention"], "simt": 0}, routes
    assert tuple(logits.shape) == (LM_BATCH, shape.seq_len, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    log(f"lm: forward (kernels on, first call) {fwd_s:.3f} s; launches "
        f"{launches}, flash routes {routes}; logits {tuple(logits.shape)} {logits.dtype}, all "
        f"finite, max |logit| {float(logits.abs().max()):.4f}; aux "
        f"{float(aux):.6f}")

    with torch.inference_mode():
        fa.flash_attention.launches = ms.mamba_scan.launches = 0
        loss = model.loss(batch)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(loss))
        assert fa.flash_attention.launches == want["flash_attention"]
        assert ms.mamba_scan.launches == want["mamba_scan"]

        # every kernel call of the forward against its plain version
        (args, kw, out), = rec["flash_attention"].calls
        want_fa = fa.attention_ref(*args, causal=kw.get("causal", True))
        err_fa = hold(torch, out, want_fa, TOL_FLASH_LM)
        mag = want_fa.float().abs()
        rel_fa = float(torch.linalg.vector_norm(out.float() - want_fa.float())
                       / torch.linalg.vector_norm(want_fa.float()))
        log(f"lm kernel flash_attention on the forward's q "
            f"{tuple(args[0].shape)} k/v {tuple(args[1].shape)} bf16, "
            f"causal: max_abs_err {err_fa:.3e} (bound {TOL_FLASH_LM}); "
            f"relative norm {rel_fa:.3e} (bound {RTOL_NORM_FLASH_LM:.3e}); "
            f"plain |out| mean {float(mag.mean()):.4e} max "
            f"{float(mag.max()):.4e}, "
            f"{float((mag > TOL_FLASH_LM['atol']).float().mean()):.2%} "
            f"above atol")
        assert rel_fa <= RTOL_NORM_FLASH_LM, rel_fa
        del want_fa, mag
        assert len(rec["mamba_scan"].calls) == want["mamba_scan"]
        err_ms = 0.0
        for i, (args, kw, (y, h)) in enumerate(rec["mamba_scan"].calls):
            yr, hr = ms.mamba_scan_ref(*args)
            e = max(hold(torch, y, yr, TOL_SCAN), hold(torch, h, hr, TOL_SCAN))
            err_ms = max(err_ms, e)
            log(f"lm kernel mamba_scan call {i} on x {tuple(args[0].shape)} "
                f"N={args[4].shape[1]}: max_abs_err {e:.3e} (bound "
                f"{TOL_SCAN}); max |y| {float(yr.abs().max()):.4f}")
            del yr, hr

        # the same forward with the plain paths
        model.use_kernel = False
        t0 = time.perf_counter()
        plain_logits, plain_aux = model(batch)
        plain_loss = model.loss(batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        model.use_kernel = True
        gap = abs(float(loss) - float(plain_loss)) / abs(float(plain_loss))
        logit_gap = float((logits.float() - plain_logits.float()).abs().max())
        log(f"lm: loss kernels {float(loss):.6f}, plain "
            f"{float(plain_loss):.6f}: relative gap {gap:.3e} (bound {RTOL_LM_LOSS}); logits max "
            f"abs gap {logit_gap:.4e}; aux {float(aux):.6f} / "
            f"{float(plain_aux):.6f}; plain forward + loss {plain_s:.2f} s")
        assert gap <= RTOL_LM_LOSS, gap
    del logits, plain_logits
    return model, batch, launches, rec, (err_fa, err_ms)


def phase_lm_times(torch, F, fa, ms, model, batch, rec, errs, card):
    """The LM kernels' device times at the forward's shapes beside their
    bounds, plain versions and library call; the forward's wall time; one
    traced forward."""
    (q, k, v), kw, _ = rec["flash_attention"].calls[0]
    causal = kw.get("causal", True)
    B, S, Hq, D = q.shape
    fa_build = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    fa_route = fa.route(q.dtype, D)
    fa_kernel = fa_build.KERNELS[fa_route]
    T, Hkv = k.shape[1], k.shape[2]
    pairs = sum(min(s + 1, T) for s in range(S)) if causal else S * T
    fa_ops = 4 * B * Hq * D * pairs
    fa_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate = BF16_OPS_S if q.dtype == torch.bfloat16 else FP32_OPS_S
    fa_bound = max(fa_bytes / HBM_BYTES_S, fa_ops / rate) * 1e3
    fa_by = "bytes" if fa_bytes / HBM_BYTES_S >= fa_ops / rate \
        else "operations"
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    with torch.inference_mode():
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
        sdpa_gap = float((sdpa.transpose(1, 2).float()
                          - fa.attention_ref(q, k, v, causal).float())
                         .abs().max())
        del sdpa
        fa_ms = device_ms(torch, lambda: fa.flash_attention(q, k, v, causal),
                          reps=10, name=fa_kernel, floor=fa_bound)
        # the same call right after 128 MB of writes (which evict the 50 MB
        # L2), and right after a 1.9 TFLOP bf16 GEMM, as in the forward
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=q.device)
        fa_cold = device_ms(torch, lambda: (
            flush.zero_(), fa.flash_attention(q, k, v, causal)), reps=10,
            name=fa_kernel, floor=fa_bound)
        a = torch.randn(16384, 4096, dtype=torch.bfloat16, device=q.device)
        w = torch.randn(4096, 14336, dtype=torch.bfloat16, device=q.device)
        fa_gemm = device_ms(torch, lambda: (
            a @ w, fa.flash_attention(q, k, v, causal)), reps=10,
            name=fa_kernel, floor=fa_bound)
        del flush, a, w
        fa_plain = device_ms(torch, lambda: fa.attention_ref(q, k, v, causal),
                             reps=3, floor=fa_bound)
        fa_lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), reps=10,
            floor=fa_bound)
    log(f"time [{card}]: flash_attention q {tuple(q.shape)} k/v "
        f"{tuple(k.shape)} {str(q.dtype)[6:]} causal, device time per call "
        f"(profiler): {fa_kernel} {fa_ms:.4f} ms (after an L2 flush "
        f"{fa_cold:.4f} ms, after a GEMM {fa_gemm:.4f} ms), plain "
        f"{fa_plain:.4f} ms, "
        f"scaled_dot_product_attention {fa_lib:.4f} ms (max |sdpa - plain| "
        f"{sdpa_gap:.3e}); bound {fa_bound:.4f} ms ({fa_by}: {fa_ops:.4e} "
        f"operations, {fa_bytes} bytes)")

    x, dt, Bt, Ct, A, D_ = rec["mamba_scan"].calls[0][0]
    Bs, L, d = x.shape
    N = A.shape[1]
    exps = Bs * L * d * N
    ms_flops = Bs * L * d * (6 * N + 3)
    ms_bytes = 4 * (3 * Bs * L * d + 2 * Bs * L * N + d * N + d + Bs * d * N)
    ms_ops_t = max(ms_flops / FP32_OPS_S, exps / SFU_EXP_S)
    ms_bound = max(ms_bytes / HBM_BYTES_S, ms_ops_t) * 1e3
    ms_by = "bytes" if ms_bytes / HBM_BYTES_S >= ms_ops_t else "operations"
    with torch.inference_mode():
        args = (x, dt, Bt, Ct, A, D_)
        ms_ms = device_ms(torch, lambda: ms.mamba_scan(*args), reps=10,
                          name="scan_kernel", floor=ms_bound)
        ms_plain = device_ms(torch, lambda: ms.mamba_scan_ref(*args), reps=1,
                             floor=ms_bound)
    log(f"time [{card}]: mamba_scan x {tuple(x.shape)} N={N} f32, device "
        f"time per call (profiler): kernel {ms_ms:.4f} ms, plain "
        f"{ms_plain:.4f} ms; bound {ms_bound:.4f} ms ({ms_by}: {ms_bytes} "
        f"bytes, {exps:.4e} exponentials, {ms_flops:.4e} float32 operations)")

    with torch.inference_mode(), ClockSampler() as clocks:
        fwd_s, _ = wall_s(torch, lambda: model(batch), 3)
        tokens = batch["tokens"].numel()
        log(f"time [{card}]: lm forward {tokens} tokens, kernels on: "
            f"{fwd_s:.4f} s (median of 3) = {tokens / fwd_s:.1f} tokens/s")
        clk_before = sm_clock()
        events, wall = steady_traces(torch, lambda: model(batch),
                                     count=2)[-1]
        clk_after = sm_clock()
    log(f"clocks [{card}]: SM clock, max (nvidia-smi) before the traced "
        f"forward {clk_before}, after it {clk_after}; sampled over the 3 "
        f"timed and the traced forward: {clocks.summary()}")
    n_fa = sum(fa_kernel in e.name for e in events)
    n_scan = sum("scan_kernel" in e.name for e in events)
    assert (n_fa, n_scan) == (1, 7), (n_fa, n_scan)
    busy = busy_ms(events)
    share = 100 * busy / 1e3 / wall
    top = top_ops(events, 6)
    log(f"time [{card}]: lm forward traced (torch.profiler, two traces "
        f"agreeing): wall "
        f"{wall:.4f} s, {len(events)} device events busy {busy:.3f} ms "
        f"({share:.2f}%; idle {100 - share:.2f}%), {fa_kernel} "
        f"{busy_ms(events, fa_kernel):.3f} ms, scan_kernel "
        f"{busy_ms(events, 'scan_kernel'):.3f} ms; top device operations: "
        + "; ".join(f"{name[:60]} {t:.2f} ms" for name, t in top))
    return [
        dict(name="flash_attention", route="cuda",
             source=str(fa_build.SOURCES[fa_route].relative_to(ROOT)),
             replaces="src/repro/kernels/flash_attention/"
                      "flash_attention.py:30",
             launches=None, max_abs_err=errs[0], ms=fa_ms, plain_ms=fa_plain,
             bound_ms=fa_bound, bound_by=fa_by, library_ms=fa_lib),
        dict(name="mamba_scan", route="cuda",
             source="src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
             replaces="src/repro/kernels/mamba_scan/mamba_scan.py:25",
             launches=None, max_abs_err=errs[1], ms=ms_ms, plain_ms=ms_plain,
             bound_ms=ms_bound, bound_by=ms_by, library_ms=None),
    ]


def hold_lm_calls(torch, fa, ms, rec) -> tuple:
    """Every recorded flash and scan call against its plain version on the
    same inputs (flash elementwise at TOL_FLASH_LM and as a whole at
    RTOL_NORM_FLASH_LM, scan y and h_final at TOL_SCAN); the records are
    emptied.  Returns (flash max_abs_err, scan max_abs_err, worst flash
    relative norm)."""
    with torch.inference_mode():
        return _hold_lm_calls(torch, fa, ms, rec)


def _hold_lm_calls(torch, fa, ms, rec) -> tuple:
    err_fa = err_ms = rel_fa = 0.0
    for args, kw, out in rec["flash_attention"].calls:
        want = fa.attention_ref(*args, causal=kw.get("causal", True),
                                q_offset=kw.get("q_offset", 0))
        err_fa = max(err_fa, hold(torch, out, want, TOL_FLASH_LM))
        rel = float(torch.linalg.vector_norm(out.float() - want.float())
                    / torch.linalg.vector_norm(want.float()))
        assert rel <= RTOL_NORM_FLASH_LM, (tuple(args[0].shape), rel)
        rel_fa = max(rel_fa, rel)
    for args, kw, (y, h) in rec["mamba_scan"].calls:
        yr, hr = ms.mamba_scan_ref(*args, h0=kw.get("h0"))
        err_ms = max(err_ms, hold(torch, y, yr, TOL_SCAN),
                     hold(torch, h, hr, TOL_SCAN))
    for r in rec.values():
        r.calls.clear()
    return err_fa, err_ms, rel_fa


def phase_serve(torch, np, fa, ms, model, card, pt, grid):
    """Serving on the full-width model of the LM phases: the static engine,
    the continuous and paged engines on one Poisson workload (both kernels
    in every prefill, each call held against its plain version), their
    steps captured for the advisor (``compiled_steps``), teacher forcing,
    the reduced f32 archs' greedy tokens across the three engines, and the
    serving times.  Returns the kernel launches of the serving path, the
    kernels' max_abs_err over its calls, and the captured steps with their
    capture time."""
    import types
    from repro_torch import configs
    from repro_torch.models import layers, make_model
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.serve import (ContinuousEngine, PagedContinuousEngine,
                                   ServeEngine, poisson_workload,
                                   run_workload)

    t_phase = time.perf_counter()
    cfg = model.cfg
    dev = torch.device(DEVICE)
    per_admission = {"flash_attention": sum(
        s.spec.mixer == "attn" for s in model.stack), "mamba_scan": sum(
        s.spec.mixer == "mamba" for s in model.stack)}
    assert per_admission == {"flash_attention": 1, "mamba_scan": 7}
    prompts = np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT)).astype(np.int32)
    work = poisson_workload(**SERVE_WORKLOAD)
    lens = [len(p) for p in work.prompts]
    log(f"serve: {cfg.name} x {cfg.n_layers} layers, {cfg.dtype}, kernels "
        f"on; workload {work.meta}: prompt lengths {lens}, budgets "
        f"{work.max_new.tolist()}, arrivals {work.arrivals.tolist()}")

    rec = {"flash_attention": _Recorder(fa.flash_attention),
           "mamba_scan": _Recorder(ms.mamba_scan)}
    fa_ops, ms_ops = layers.fa_ops, mamba_mod.ms_ops
    layers.fa_ops = types.SimpleNamespace(
        flash_attention=rec["flash_attention"])
    mamba_mod.ms_ops = types.SimpleNamespace(mamba_scan=rec["mamba_scan"])
    errs, runs = [], []
    try:
        fa.flash_attention.launches = 0
        fa.flash_attention.route_launches = {"sm90": 0, "simt": 0}
        ms.mamba_scan.launches = 0
        # (a) the static engine
        static = ServeEngine(model=model, max_len=SERVE_MAX_LEN)
        t0 = time.perf_counter()
        gen = static.generate(prompts, SERVE_NEW)
        torch.cuda.synchronize()
        static_s = time.perf_counter() - t0
        assert tuple(gen.shape) == (SERVE_BATCH, SERVE_NEW)
        n_calls = {k: len(r.calls) for k, r in rec.items()}
        assert n_calls == per_admission, n_calls
        errs.append(hold_lm_calls(torch, fa, ms, rec))
        log(f"serve (a): ServeEngine.generate {SERVE_BATCH} x {SERVE_PROMPT}"
            f" prompt tokens + {SERVE_NEW} new in {static_s:.3f} s (first "
            f"call) [{card}]; kernel calls {n_calls}, each held against its "
            f"plain version: flash max_abs_err {errs[-1][0]:.3e}, relative "
            f"norm {errs[-1][2]:.3e}, scan {errs[-1][1]:.3e}")
        # (c) the continuous and paged engines on one workload, in turns
        make = {"continuous": lambda: ContinuousEngine(
                    model=model, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN),
                "paged": lambda: PagedContinuousEngine(
                    model=model, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                    block_size=SERVE_BLOCK)}
        for name in SERVE_TURNS:
            eng = make[name]()
            outs, report = run_workload(eng, work)
            runs.append((name, eng, outs, report))
            n_calls = {k: len(r.calls) for k, r in rec.items()}
            want = {k: v * len(work) for k, v in per_admission.items()}
            assert n_calls == want, (name, n_calls, want)
            errs.append(hold_lm_calls(torch, fa, ms, rec))
            log(f"serve (c) {name}: kernel calls {n_calls} ({len(work)} "
                f"admissions), each held against its plain version: flash "
                f"max_abs_err {errs[-1][0]:.3e}, relative norm "
                f"{errs[-1][2]:.3e}, scan {errs[-1][1]:.3e}")
        torch.cuda.synchronize()
        launches = {"flash_attention": fa.flash_attention.launches,
                    "mamba_scan": ms.mamba_scan.launches}
        routes = dict(fa.flash_attention.route_launches)
    finally:
        layers.fa_ops, mamba_mod.ms_ops = fa_ops, ms_ops
    admissions = 1 + len(SERVE_TURNS) * len(work)
    want = {k: v * admissions for k, v in per_admission.items()}
    assert launches == want, (launches, want)
    assert routes == {"sm90": want["flash_attention"], "simt": 0}, routes
    first = runs[0][2]
    for name, _, outs, _ in runs[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(first, outs)), \
            f"{name} tokens differ from the first run's"
    assert [len(o) for o in first] == work.max_new.tolist()
    log(f"serve (d): launches over the static run and the runs "
        f"{', '.join(SERVE_TURNS)} {launches} = {admissions} admissions x "
        f"{per_admission}, flash routes {routes}; decode launched none; "
        f"every run's tokens equal ({sum(map(len, first))} tokens)")
    for name, eng, _, report in runs:
        st = eng.stats
        log(f"serve [{card}] {name}: {report.as_dict()}; decode steps "
            f"{st.decode_steps}, occupancy {st.occupancy:.3f}, prefills "
            f"{st.prefills} ({st.prefill_tokens} tokens), wall "
            f"{st.wall_s:.3f} s")
    paged = runs[-2][1].stats
    log(f"serve: paged kv_bytes_peak {paged.kv_bytes_peak} against "
        f"kv_bytes_dense {paged.kv_bytes_dense} "
        f"({paged.kv_bytes_peak / paged.kv_bytes_dense:.3f})")
    serve_steps = capture_serve_steps(torch, np, pt, fa, ms, model, static,
                                      runs[-1][1], runs[-2][1], grid, card)
    del runs, first
    torch.cuda.empty_cache()

    # (b) teacher forcing on the served bf16 model
    rels, moved = teacher_force(torch, model, prompts, gen)
    clean = rels[~moved] if (~moved).any() else np.full(1, np.nan)
    log(f"serve (b) bf16: prefill + {SERVE_NEW} decode steps against the "
        f"forward over the same {SERVE_PROMPT + SERVE_NEW} tokens: decode's "
        f"greedy choices repeat the engine's; relative norm of each row's "
        f"logits per step max {rels.max():.3e}, median "
        f"{float(np.median(rels)):.3e}; {int(moved.sum())} of {moved.size} "
        f"positions routed or dropped otherwise by an MoE layer of the "
        f"forward (max {rels[moved].max() if moved.any() else 0:.3e}), the "
        f"other {int((~moved).sum())} max {clean.max():.3e} median "
        f"{float(np.median(clean)):.3e}; {int((rels <= RTOL_NORM_SERVE).sum())}"
        f" within the bf16 forward's bound {RTOL_NORM_SERVE} (logged, not "
        f"held: the float32 check below holds the cache)")

    # (e) the reduced f32 archs: one greedy output from three engines
    for arch in SERVE_F32_ARCHS:
        small = make_model(configs.get_arch(arch).reduced(), use_kernel=True,
                           device=DEVICE, generator=torch.Generator(
                               device=DEVICE).manual_seed(LM_SEED))
        ps = np.random.default_rng(1).integers(
            0, small.cfg.vocab_size, size=(3, 7)).astype(np.int32)
        want = ServeEngine(model=small, max_len=16).generate(ps, 5)
        want = want.cpu().numpy()
        reqs = [(ps[i], 5, i) for i in range(3)]
        got = {"continuous": ContinuousEngine(model=small, n_slots=2,
                                              max_len=16).run(reqs),
               "paged": PagedContinuousEngine(model=small, n_slots=2,
                                              max_len=16,
                                              block_size=4).run(reqs)}
        for name, outs in got.items():
            assert np.array_equal(np.stack(outs), want), (arch, name, outs,
                                                          want)
        log(f"serve (e): {arch} reduced, float32, kernels on: greedy tokens "
            f"equal across the static, continuous and paged engines "
            f"{want.tolist()}")
        del small

    # (f) times: prefill by prompt length, the 8-slot decode step
    with torch.inference_mode():
        rng = np.random.default_rng(LM_SEED + 1)
        for L in SERVE_PREFILL_LENS:
            batch = {"tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab_size, size=(1, L), dtype=np.int32), device=dev)}
            t = cuda_ms(torch, lambda: model.prefill(batch, SERVE_MAX_LEN),
                        reps=5, warmup=1)
            log(f"time [{card}]: prefill of {L} tokens (batch 1, kernels "
                f"on, CUDA events, median of 5): {t:.3f} ms = "
                f"{L / t * 1e3:.1f} tokens/s")
        caches = model.init_caches(SERVE_SLOTS, SERVE_MAX_LEN)
        tok = torch.as_tensor(prompts[:1, :SERVE_SLOTS].T.copy(), device=dev)
        pos = torch.arange(SERVE_SLOTS, device=dev, dtype=torch.int32) \
            * (SERVE_MAX_LEN // SERVE_SLOTS) + SERVE_PROMPT // 4
        step = lambda: model.decode_step(caches, {"tokens": tok}, pos)
        dec_ms = cuda_ms(torch, step, reps=25, warmup=3)
        events, wall = steady_traces(torch, step, count=2)[-1]
        busy = busy_ms(events)
        share = 100 * busy / 1e3 / wall
        log(f"time [{card}]: decode step of {SERVE_SLOTS} slots (a position "
            f"each, cache {SERVE_MAX_LEN}): {dec_ms:.3f} ms (CUDA events, "
            f"median of 25) = {SERVE_SLOTS / dec_ms * 1e3:.1f} tokens/s; "
            f"traced (two traces agreeing): wall {wall * 1e3:.3f} ms, "
            f"{len(events)} device events busy {busy:.3f} ms ({share:.2f}%; "
            f"idle {100 - share:.2f}%); top device operations: "
            + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in
                        top_ops(events, 8)))
        del caches
    # (b) teacher forcing in float32, nothing dropped by the MoE layers:
    # bf16 rounds decode and the forward differently, and the forward's
    # capacity (all 2 x 1,056 tokens at once) drops assignments that the
    # engine's prefill and decode keep; the model is served no further
    model.float()
    model.cfg = cfg.replace(
        capacity_factor=cfg.n_experts / cfg.experts_per_token)
    torch.cuda.empty_cache()
    gen32 = ServeEngine(model=model, max_len=SERVE_MAX_LEN).generate(
        prompts, SERVE_NEW)
    rels, moved = teacher_force(torch, model, prompts, gen32)
    log(f"serve (b) float32, capacity {model.cfg.capacity_factor:g} (no "
        f"drops): relative norm of each row's logits per step max "
        f"{rels.max():.3e}, median {float(np.median(rels)):.3e} (bound "
        f"{RTOL_NORM_SERVE_F32}); {int(moved.sum())} positions routed "
        f"otherwise; {int((gen32 == gen).sum())} of {gen.numel()} greedy "
        f"tokens as in bf16")
    assert rels.max() <= RTOL_NORM_SERVE_F32 and not moved.any(), rels
    model.cfg = cfg
    log(f"serve: phase {time.perf_counter() - t_phase:.1f} s")
    worst = [max(e[i] for e in errs) for i in range(2)]
    return launches, worst, serve_steps


def capture_serve_steps(torch, np, pt, fa, ms, model, static, cont, paged,
                        grid, card):
    """(b) of the advisor phase: the static, continuous and paged engines'
    steps captured with the kernels on (``compiled_steps``; nothing runs,
    nothing launches), each step's flops beside ``analytic.model_flops``
    for its shape, each kernel one node of every prefill, and every engine
    priced to a speedup of 1.0 in every scenario (one card: no
    collectives).  Returns ({"engine/step": CapturedStep}, seconds)."""
    from repro_torch.core import analytic
    from repro_torch.models.config import ShapeConfig
    cfg = model.cfg
    before = (fa.flash_attention.launches, ms.mamba_scan.launches)
    engines = (("static", static, dict(batch_size=SERVE_BATCH,
                                        prompt_len=SERVE_PROMPT)),
               ("continuous", cont, {}), ("paged", paged, {}))
    steps, secs = {}, 0.0
    for name, eng, kw in engines:
        t0 = time.perf_counter()
        got = eng.compiled_steps(**kw)
        dt = time.perf_counter() - t0
        secs += dt
        batch = SERVE_BATCH if name == "static" else SERVE_SLOTS
        for key, step in got.items():
            steps[f"{name}/{key}"] = step
            kind, _, L = key.partition("@")
            n_prefill = 1 if name != "static" else SERVE_BATCH
            shape = ShapeConfig(key, "decode", SERVE_MAX_LEN, batch) \
                if kind == "decode" else \
                ShapeConfig(key, "prefill", int(L), n_prefill)
            mf = analytic.model_flops(cfg, shape)
            cost = step.cost()
            assert step.collectives() == [], (name, key)
            assert cost["flops"] > 0 and cost["bytes accessed"] > 0
            kern = {k: step.ops[f"repro_torch::{k}"]
                    for k in ("flash_attention", "mamba_scan")}
            want = {"flash_attention": 1, "mamba_scan": 7} \
                if kind == "prefill" else {"flash_attention": 0,
                                           "mamba_scan": 0}
            assert kern == want, (name, key, kern)
            rf = step.roofline(pt.H100)
            log(f"advisor (b) [{card}]: {name} {key}: flops "
                f"{cost['flops']:.6e} against model_flops "
                f"{mf:.6e} (x{cost['flops'] / mf:.4f}), bytes "
                f"{cost['bytes accessed']:.6e}, {sum(step.ops.values())} "
                f"ops, kernel ops {kern}; H100 roofline {rf.step_time_s * 1e3:.4f} ms "
                f"({rf.dominant})")
        log(f"advisor (b): {name} engine compiled_steps() captured "
            f"{len(got)} steps in {dt:.2f} s")
    assert (fa.flash_attention.launches, ms.mamba_scan.launches) == before
    res = pt.price(static, grid)
    sp = res.predicted_speedup()
    assert sp.shape == (len(grid),)
    np.testing.assert_allclose(sp, 1.0, rtol=RTOL_ADVISOR, atol=0)
    for name in ("continuous", "paged"):
        mine = {k: v for k, v in steps.items() if k.startswith(name + "/")}
        sp = pt.price(mine, grid).predicted_speedup()
        worst = float(np.abs(sp - 1.0).max())
        np.testing.assert_allclose(sp, 1.0, rtol=RTOL_ADVISOR, atol=0,
                                   err_msg=name)
    log(f"advisor (b): price(engine, grid) speedup 1.0 in all {len(grid)} "
        f"scenarios for the three engines (one card, no collectives; a "
        f"deployment's sum over its steps within {worst:.1e} of 1); "
        f"captures launched no kernel; {secs:.2f} s of capture")
    return steps, secs


def _hpcg_sites(levels, per_level, iters):
    """The (kind, bytes, group, multiplier) multiset of the HPCG solve's
    call sites: per V-cycle level, two collective-permutes of one plane
    per ``apply_a`` (level 0 also has the loop's ``apply_a(p)``), inside
    the loop (x ``iters``) and once before it; four scalar all-reduces."""
    import collections
    sites = collections.Counter()
    for nx, n_apply in zip(levels, per_level):
        for mult in (float(iters), 1.0):
            sites[("collective-permute", nx * nx * 4, 1, mult)] += 2 * n_apply
    for mult in (float(iters), 1.0):
        sites[("all-reduce", 4, HPCG_RANKS, mult)] += 2
    return sites


def phase_advisor(torch, np, pt, sb, grid_mesh, st, hp, grid, app_times,
                  serve_steps, card):
    """The advisor on compiled programs: (a) the paper's apps captured at
    full size (the stencil step on both backends, the HPCG solve), with
    the card's allocations held still; (b) the serving steps (captured in
    the serve phase); (c) every captured step, the JAX package's synthetic
    HLO texts and a tensor-parallel step under a fake 4-rank process group,
    priced in ONE multi-subject call under the main path's scenarios: one
    bracket launch, held against the host at rtol 1e-9, and the paper's
    three answers per site.  Returns the bracket kernel's launches."""
    import collections
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fcoll
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.core.advisor import lower_subject
    from repro_torch.core.graph import abstract, capture
    from repro_torch.kernels.sweep_bracket.ops import bracket_resident

    dev = torch.device(DEVICE)
    f32 = torch.float32
    serve_steps, serve_s = serve_steps
    t_phase = time.perf_counter()

    # (a) the apps, captured: fake inputs, so nothing is allocated
    px, py = STENCIL_GRID
    tiles = abstract(torch.zeros, (px, py, STENCIL_TILE, STENCIL_TILE),
                     dtype=f32, device=dev)
    shape = (HPCG_RANKS * HPCG_NX_FULL, HPCG_NX_FULL, HPCG_NX_FULL)
    b, x0 = (abstract(torch.zeros, shape, dtype=f32, device=dev)
             for _ in range(2))
    working = (tiles.numel() + b.numel()) * 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    apps, cap_s = {}, {}
    for backend in ("message_based", "message_free"):
        t0 = time.perf_counter()
        # one capture per backend: two steps, not one step recaptured
        apps[f"stencil/{backend}"] = capture(  # repro_torch: noqa[compile-in-loop]
            st.make_step(grid_mesh(px, py), backend), tiles,
            name=f"stencil_{backend}")
        cap_s[f"stencil/{backend}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    apps["hpcg/message_based"] = capture(
        hp.make_cg(grid_mesh(HPCG_RANKS), "message_based",
                   n_iter=HPCG_ITERS), b, x0, name="hpcg_solve")
    cap_s["hpcg/message_based"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown < ADVISOR_MEM_SHARE * working, (grown, working)
    log(f"advisor (a): captures grew the card's allocations by {grown} B "
        f"(peak; bound {ADVISOR_MEM_SHARE:.0%} of the apps' {working} B)")

    strip = STENCIL_TILE * 4
    want = {"stencil/message_based": collections.Counter(
                {("collective-permute", strip, 1, 1.0): 4}),
            "stencil/message_free": collections.Counter(),
            "hpcg/message_based": _hpcg_sites(
                HPCG_LEVEL_NX, (4, 3, 3, 1), HPCG_ITERS)}
    for key, step in apps.items():
        ops = step.collectives()
        sig = collections.Counter((o.kind, o.result_bytes, o.group_size,
                                   o.multiplier) for o in ops)
        assert sig == want[key], (key, sig)
        bundle = pt.synthesize_bundle(step)
        cost, rf = step.cost(), step.roofline(pt.H100)
        app, backend = key.split("/")
        measured = (f"step {app_times['stencil'][backend]:.4f} ms measured "
                    "in phase 7" if app == "stencil" else
                    "solve " + ", ".join(f"{t:.4f} s" for t in
                                         app_times["hpcg"][backend])
                    + " measured in phase 8")
        ar = sorted((o.multiplier, o.result_bytes, o.group_size)
                    for o in ops if o.kind == "all-reduce")
        log(f"advisor (a) [{card}]: {key}: captured in {cap_s[key]:.2f} s, "
            f"{sum(step.ops.values())} ops; {len(ops)} call "
            f"sites ({dict(collections.Counter(o.kind for o in ops))}), "
            f"{len(bundle.call_sites)} priced (min_group 2), wire_bytes "
            f"{bundle.meta['wire_bytes']:.0f}; all-reduce sites "
            f"(multiplier, bytes, group) {ar}; flops {cost['flops']:.6e}, "
            f"bytes {cost['bytes accessed']:.6e}; H100 roofline step "
            f"{rf.step_time_s * 1e3:.4f} ms ({rf.dominant}) against the "
            f"{measured}")

    dispatch_cost(torch, apps["hpcg/message_based"].ops, card)

    # (c) a tensor-parallel MLP step under a fake 4-rank process group
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ADVISOR_FAKE_RANKS)
    try:
        group = dist.group.WORLD
        T, d, f = ADVISOR_TP_SHAPE
        bf16 = torch.bfloat16
        x, w1, w2 = (abstract(torch.zeros, s_, dtype=bf16, device=dev)
                     for s_ in ((T // ADVISOR_FAKE_RANKS, d), (d, f), (f, d)))

        def tp_mlp(x, w1, w2):
            full = fcoll.all_gather_tensor(x, 0, group)
            y = torch.nn.functional.gelu(full @ w1) @ w2
            y = fcoll.reduce_scatter_tensor(y, "sum", 0, group)
            return y, fcoll.all_reduce(y.float().square().sum(), "sum",
                                       group)

        tp = capture(tp_mlp, x, w1, w2, name="tp_mlp")
    finally:
        dist.destroy_process_group()
    tp_ops = [(o.kind, o.result_bytes, o.group_size) for o in
              tp.collectives()]
    assert tp_ops == [("all-gather", T * d * 2, 4),
                      ("reduce-scatter", T // 4 * d * 2, 4),
                      ("all-reduce", 4, 4)], tp_ops
    assert tp.cost()["flops"] == 2 * 2 * T * d * f
    log(f"advisor (c): fake {ADVISOR_FAKE_RANKS}-rank tensor-parallel MLP "
        f"({T} tokens, d {d}, d_ff/rank {f}, bf16): sites {tp_ops}")

    subjects = {**apps, **serve_steps, "hlo/synth_a": SYNTH_HLO_A,
                "hlo/synth_b": SYNTH_HLO_B, "hlo/synth": SYNTH_HLO,
                "fake4/tp_mlp": tp}
    adv = pt.CommAdvisor()
    cbs = [pt.compile_bundle(lower_subject(v, adv.params, adv.spec))
           for v in subjects.values()]
    n_sites = sum(cb.n_calls for cb in cbs)
    route = "resident" if bracket_resident(
        pt.concat_bundles(cbs).tensors(dev).groups.values()) else "tiled"
    sb.fused_bracket_segsum.launches = 0
    t0 = time.perf_counter()
    res = pt.price(subjects, grid)
    torch.cuda.synchronize()
    price_s = time.perf_counter() - t0
    n_launch = sb.fused_bracket_segsum.launches
    assert n_launch == 1, n_launch
    t0 = time.perf_counter()
    host = pt.price(subjects, grid, plan="numpy")
    host_s = time.perf_counter() - t0
    worst = 0.0
    for name, r, h in zip(res.names, res, host):
        assert r.call_ids == h.call_ids, name
        for fld in pt.MATRIX_FIELDS:
            a, w = getattr(r, fld), getattr(h, fld)
            assert a.shape == (len(grid), len(r.call_ids)), (name, fld)
            np.testing.assert_allclose(a, w, rtol=RTOL_ADVISOR, atol=0,
                                       err_msg=f"{name} {fld}")
            if a.size:
                worst = max(worst, rel_diff(np, a, w))
    log(f"advisor (c): price() of {len(subjects)} subjects ({n_sites} "
        f"sites, the {route} route) under {len(grid)} scenarios on the "
        f"card: {price_s:.3f} s, bracket launches {n_launch}; the host "
        f"'numpy' plan {host_s:.3f} s; max rel diff {worst:.3e} (rtol "
        f"{RTOL_ADVISOR})")
    for name, r in zip(res.names, res):
        if not r.call_ids:
            continue
        gain = r.gain_ns
        share = (gain > 0).mean(axis=0)
        order = np.argsort(-gain.mean(axis=0), kind="stable")
        best = r.best_scenario()
        label = grid.label_at(best)
        log(f"advisor (c) {name}: beneficial share " + ", ".join(
            f"{r.call_ids[j]} {share[j]:.4f}" for j in range(len(share)))
            + "; ranked by mean gain " + ", ".join(
                f"{r.call_ids[j]} ({gain[:, j].mean() / 1e3:.3f} us)"
                for j in order)
            + f"; best scenario {best} (speedup "
            f"{r.predicted_speedup()[best]:.6f}) "
            + ", ".join(f"{k}={v:.1f}" for k, v in label.items()
                        if isinstance(v, float)))
    total = time.perf_counter() - t_phase + serve_s
    log(f"advisor: phase {total:.1f} s ({serve_s:.1f} s of it capturing "
        f"the engines in phase 12)")
    return n_launch


def dispatch_cost(torch, hpcg_ops, card):
    """Host time of a call through a custom op (``torch.library``, as the
    stacked-rank collectives and the three kernel wrappers are) against
    the plain operations it runs, on small tensors on the card so that
    the host's side is what is timed: each pair in turns (op, plain,
    plain, op), the mean of ``DISPATCH_CALLS`` calls each.  Logs the cost
    a call, with the calls of each path (the HPCG solve's from its
    capture)."""
    import functools
    from repro_torch.comm import collectives
    dev = torch.device(DEVICE)
    x = torch.randn(8, 1, 64, 64, device=dev)
    src = [7, 0, 1, 2, 3, 4, 5, 6]
    idx = torch.tensor(src, device=dev)
    part = torch.randn(8, device=dev)
    pairs = {"ppermute": (lambda: collectives.ppermute(x, 0, src, 1),
                          lambda: x.index_select(0, idx)),
             "rank_sum": (lambda: collectives.rank_sum(part),
                          lambda: functools.reduce(torch.add,
                                                   part.unbind(0)))}

    def per_call_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DISPATCH_CALLS * 1e6

    out = []
    for name, (op, plain) in pairs.items():
        per_call_us(op), per_call_us(plain)                  # warm
        o1, p1, p2, o2 = (per_call_us(f) for f in (op, plain, plain, op))
        assert torch.equal(op(), plain())
        out.append(f"{name} {(o1 + o2) / 2:.2f} us against the plain "
                   f"{(p1 + p2) / 2:.2f} us (+{(o1 + o2 - p1 - p2) / 2:.2f})")
    log(f"custom-op dispatch [{card}]: host time a call, mean of "
        f"{DISPATCH_CALLS} in turns: " + "; ".join(out) + "; calls per "
        f"path: stencil step 4 ppermute (message_based), HPCG "
        f"message_based solve {hpcg_ops['repro_torch::ppermute']} ppermute "
        f"+ {hpcg_ops['repro_torch::rank_sum']} rank_sum (its capture), "
        f"message_free solve 286 ring_halo_exchange + the same rank_sum, "
        f"LM forward and each prefill 1 flash_attention + 7 mamba_scan")


def teacher_force(torch, model, prompts, gen):
    """``model.prefill`` of ``prompts`` and a ``decode_step`` for each
    token of ``gen`` against ``model(prompts + gen)``.  Returns, for each
    row and each of the 1 + n positions: the relative norm of the logits,
    and whether an MoE layer of the forward routed that position to other
    experts than prefill / decode did or dropped one of its assignments
    there.  Decode's greedy choices must repeat ``gen``."""
    from repro_torch.models import moe

    S, n = prompts.shape[1], gen.shape[1]
    routes = []                       # (sorted top-k, all kept) per call
    moe_ffn = moe.moe_ffn

    def recording(p, x, cfg, impl="scatter", per_row=False, mesh=None,
                  **kw):
        B, T, d = x.shape
        _, topi, _ = moe._route(p, x.reshape(B * T, d), cfg)
        groups = B if per_row else 1
        flat = topi.reshape(groups, -1)
        onehot = torch.nn.functional.one_hot(flat, cfg.n_experts)
        rank = (onehot.cumsum(1) - 1).gather(2, flat[..., None])[..., 0]
        keep = rank < moe.capacity(cfg, B * T // groups)
        routes.append((topi.sort(-1)[0].reshape(B, T, -1),
                       keep.reshape(B, T, -1).all(-1)))
        return moe_ffn(p, x, cfg, impl=impl, per_row=per_row, mesh=mesh,
                       **kw)

    moe.moe_ffn = recording
    try:
        with torch.inference_mode():
            toks = torch.as_tensor(prompts, device=torch.device(DEVICE))
            logits, caches = model.prefill({"tokens": toks}, SERVE_MAX_LEN)
            steps = [logits[:, 0]]
            for i in range(n):
                logits, caches = model.decode_step(
                    caches, {"tokens": gen[:, i:i + 1]}, S + i)
                steps.append(logits[:, 0])
            del caches
            assert torch.equal(torch.stack(steps[:-1], 1).argmax(-1).int(),
                               gen)
            # each MoE layer's routing of the 1 + n positions as served:
            # the prefill's last position, then one decode call per step
            n_moe = len(routes) // (1 + n)
            served = [[torch.cat([routes[k * n_moe + m][f][:, -1:]
                                  for k in range(1 + n)], 1) for f in (0, 1)]
                      for m in range(n_moe)]
            routes.clear()
            full, _ = model({"tokens": torch.cat([toks, gen], 1)})
            want = full[:, S - 1:].float()
            got = torch.stack(steps, 1).float()
            rels = (torch.linalg.vector_norm(got - want, dim=-1)
                    / torch.linalg.vector_norm(want, dim=-1))
            del full, want, got, steps
    finally:
        moe.moe_ffn = moe_ffn
    moved = torch.zeros_like(rels, dtype=torch.bool)
    for (topi, keep), (s_topi, s_keep) in zip(routes, served):
        moved |= (topi[:, S - 1:] != s_topi).any(-1) | ~keep[:, S - 1:] \
            | ~s_keep
    return rels.cpu().numpy(), moved.cpu().numpy()


def device_events(torch, fn) -> tuple:
    """(device events as (name, ms) pairs, wall seconds) of one call of
    ``fn()`` under ``torch.profiler`` with CUDA activity only, read from
    the profiler's raw events: building its ``FunctionEvent`` tree costs
    about 0.1 ms an event, and a training step has some 175,000.
    :data:`LEAD_SPINS` spin kernels lead (the profiler can lose a trace's
    first events) and are left out."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.duration_ns() / 1e6)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda and "spin_kernel" not in e.name()]
    if not events:
        raise RuntimeError("the profiler saw no device events")
    return events, wall


def hold_step(np, got, before, want, lr_sum):
    """Parameters after a train step against another device's: every entry
    within 2 x the summed learning rates (a gradient near zero whose sign
    differs moves its entry by 2 lr in Adam's first step), and 99% of all
    entries within rtol 1e-3 of the other's update (atol 1e-6 of the
    leaf's magnitude), the CPU tests' bound.  Returns the largest
    difference."""
    n_close = n_all = 0
    worst = 0.0
    for g, b, w in zip(got, before, want):
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        diff = np.abs(g - w)
        worst = max(worst, float(diff.max(initial=0.0)))
        assert worst <= 2 * lr_sum + 1e-6 * scale, (worst, lr_sum)
        n_close += int((diff <= 1e-3 * np.abs(w - b) + 1e-6 * scale).sum())
        n_all += diff.size
    assert n_close >= 0.99 * n_all, n_close / n_all
    return worst


def phase_train(torch, np, card):
    """Training on the card: (a) the full-width qwen2.5-3b step, its times,
    trace and peak memory; (b) every reduced arch's step on the card
    against the CPU; (c) the restart through ``launch.train.train``; (d)
    both launchers' command lines.  The train path builds its models
    without the kernels, as the reference's trainer does."""
    t_phase = time.perf_counter()
    log(f"train: the card holds {torch.cuda.memory_allocated() / 1e9:.3f} "
        "GB before the phase")
    train_full_width(torch, np, card)
    torch.cuda.empty_cache()
    train_reduced_vs_cpu(torch, np)
    train_restart(torch)
    train_launchers()
    log(f"train: phase {time.perf_counter() - t_phase:.1f} s")


def train_full_width(torch, np, card):
    """(a) qwen2.5-3b at full width: the steps' losses and times, tokens/s,
    model TFLOP/s, the peak memory and one traced step."""
    from repro_torch import configs
    from repro_torch.core.analytic import model_flops
    from repro_torch.models import make_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import reference_leaves
    from repro_torch.train import AdamWConfig, adamw_init, make_data
    from repro_torch.train import make_train_step

    # (a) the full-width step
    cfg = configs.get_arch(TRAIN_ARCH).replace(remat=True)
    base = configs.get_shape("train_4k")
    shape = ShapeConfig(base.name, "train", base.seq_len, TRAIN_BATCH)
    gen = torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED)
    torch.cuda.reset_peak_memory_stats()
    model = make_model(cfg, device=DEVICE, generator=gen)
    n_params = model.param_count()
    leaves = reference_leaves(model)
    state = adamw_init(leaves)
    data = make_data(cfg, shape, seed=TRAIN_SEED, device=DEVICE,
                     n_templates=TRAIN_TEMPLATES)
    step = make_train_step(model.loss, AdamWConfig(**TRAIN_OPT),
                           n_micro=TRAIN_MICRO)
    log(f"train (a): {cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads, vocab {cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}: "
        f"{n_params:,} parameters in {len(leaves)} reference leaves; "
        f"AdamW {TRAIN_OPT}, f32 moments; batch {TRAIN_BATCH} x "
        f"{shape.seq_len} (train_4k's 256 rows cut to {TRAIN_BATCH}), "
        f"n_micro {TRAIN_MICRO} (f32 accumulation), synthetic task of "
        f"{TRAIN_TEMPLATES} templates")
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, state, m = step(leaves, state, batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(m.loss))
        log(f"train (a): step {i + 1} loss {losses[-1]:.6f} grad_norm "
            f"{float(m.grad_norm):.6f} lr {float(m.lr):.4e}: "
            f"{times[-1]:.2f} ms (CUDA events) [{card}]")
        assert np.isfinite(losses[-1]) and np.isfinite(float(m.grad_norm))
    peak = torch.cuda.max_memory_allocated()
    assert losses[-1] < losses[0], losses
    step_s = statistics.median(times[1:]) / 1e3
    tokens = TRAIN_BATCH * shape.seq_len
    flops = model_flops(cfg, shape)
    tflops = flops / step_s / 1e12
    log(f"train (a): step {step_s:.4f} s (median of steps 2-{TRAIN_STEPS} "
        f"by CUDA events), {tokens / step_s:,.1f} tokens/s; model_flops "
        f"{flops:.4e} -> {tflops:.2f} TFLOP/s = "
        f"{tflops * 1e12 / BF16_PEAK_FLOPS:.2%} of the {BF16_PEAK_FLOPS / 1e12:.0f}"
        f" TFLOP/s bf16 peak; peak memory {peak / 1e9:.3f} GB "
        f"(max_memory_allocated) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.3f} GB; "
        f"loss {losses[0]:.6f} -> {losses[-1]:.6f} [{card}]")
    k = [TRAIN_STEPS]

    def one_step():
        nonlocal state
        _, state, _m = step(leaves, state, data.batch(k[0]))
        k[0] += 1

    t0 = time.perf_counter()
    events, wall = device_events(torch, one_step)
    busy = sum(ms for _, ms in events)
    by_name = {}
    for name, ms in events:
        by_name[name] = by_name.get(name, 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    gemms = {name: ms for name, ms in by_name.items()
             if "gemm" in name or "nvjet" in name}
    f32_gemm = sum(ms for name, ms in gemms.items() if "f32f32" in name)
    log(f"train (a): one traced step ({time.perf_counter() - t0:.1f} s with "
        f"the trace): {len(events)} device events, busy {busy:.2f} ms: "
        f"{busy / wall / 1e1:.1f}% of its {wall * 1e3:.2f} ms wall under the "
        f"profiler, {busy / statistics.median(times[1:]) * 1e2:.1f}% of the "
        f"untraced step; float32 GEMMs {f32_gemm:.2f} ms, other GEMMs "
        f"{sum(gemms.values()) - f32_gemm:.2f} ms [{card}]; top device "
        "operations: "
        + "; ".join(f"{name[:90]} {ms:.2f} ms" for name, ms in top))
    del model, leaves, state, data, step, events, by_name


def train_reduced_vs_cpu(torch, np):
    """(b) every reduced arch in float32: one step on the card and one on
    the CPU from the same parameters and batch."""
    from repro_torch import configs
    from repro_torch.models import make_inputs, make_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import reference_leaves
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    seq, rows = TRAIN_SMALL_SHAPE
    small_shape = ShapeConfig("t", "train", seq, rows)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    worst = {"loss": 0.0, "grad_norm": 0.0, "params": 0.0}
    cases = [(a, impl)
             for a in sorted(set(configs.ARCHS) - configs.PORT_ONLY)
             for impl in (("dense", "scatter")
                          if configs.get_arch(a).n_experts else ("dense",))]
    for arch, impl in cases:
        small = configs.get_arch(arch).reduced().replace(remat=True)
        out = {}
        for dev in ("cpu", DEVICE):
            g = torch.Generator().manual_seed(TRAIN_SEED)
            mdl = make_model(small, moe_impl=impl, device="cpu",
                             generator=g).to(dev)
            lv = reference_leaves(mdl)
            before = [leaf.value().float().cpu().numpy() for leaf in lv]
            batch = {k_: v.to(dev) for k_, v in make_inputs(
                small, small_shape, seed=TRAIN_SEED, device="cpu").items()}
            _, _, m = make_train_step(mdl.loss, opt_cfg, n_micro=2)(
                lv, adamw_init(lv), batch)
            out[dev] = (float(m.loss), float(m.grad_norm), float(m.lr),
                        [leaf.value().float().cpu().numpy() for leaf in lv])
        (l_c, g_c, lr, p_c), (l_g, g_g, _, p_g) = out["cpu"], out[DEVICE]
        e_l, e_g = abs(l_g - l_c) / abs(l_c), abs(g_g - g_c) / abs(g_c)
        assert e_l <= TRAIN_RTOL and e_g <= TRAIN_RTOL, (arch, impl, e_l, e_g)
        e_p = hold_step(np, p_g, before, p_c, lr)
        worst = {"loss": max(worst["loss"], e_l),
                 "grad_norm": max(worst["grad_norm"], e_g),
                 "params": max(worst["params"], e_p)}
    log(f"train (b): {len(cases)} reduced cases (every arch, MoE archs with "
        f"dense and scatter), float32, remat on, one AdamW step of {rows} x "
        f"{seq} tokens in 2 microbatches on the card and on the CPU from "
        f"the same parameters and batch: loss relative error max "
        f"{worst['loss']:.3e}, grad norm {worst['grad_norm']:.3e} (bound "
        f"{TRAIN_RTOL}); parameters after the step max |diff| "
        f"{worst['params']:.3e} (bound 2 lr = {2 * opt_cfg.lr:.0e}, 99% of "
        "entries within rtol 1e-3 of the update)")


def train_restart(torch):
    """(c) the restart through ``launch.train.train``: uninterrupted, failed
    at ``fail_at``, resumed; the parameters must agree."""
    import contextlib
    import io
    import tempfile
    from repro_torch import configs
    from repro_torch.launch.train import train
    from repro_torch.models.config import ShapeConfig

    r = TRAIN_RESTART
    for arch, kw in r["archs"]:
        small = configs.get_arch(arch).reduced(**kw)
        sh = ShapeConfig("t", "train", 32, 4)
        quiet = io.StringIO()
        with tempfile.TemporaryDirectory() as ckdir, \
                contextlib.redirect_stdout(quiet):
            ref, hist_ref = train(small, sh, r["n_steps"], log_every=1,
                                  device=DEVICE)
            try:
                train(small, sh, r["n_steps"], ckpt_dir=ckdir,
                      ckpt_every=r["every"], log_every=1,
                      fail_at_step=r["fail_at"], device=DEVICE)
            except RuntimeError as e:
                assert "injected failure" in str(e), e
            else:
                raise AssertionError("the injected failure did not fire")
            resumed, hist = train(small, sh, r["n_steps"], ckpt_dir=ckdir,
                                  ckpt_every=r["every"], log_every=1,
                                  device=DEVICE)
        text = quiet.getvalue()
        want_line = (f"[train] restored step {r['every']}, resuming at "
                     f"{r['every'] + 1}")
        assert want_line in text, text
        assert [h["step"] for h in hist] == list(range(r["every"] + 1,
                                                       r["n_steps"]))
        want = ref.state_dict()
        err = 0.0
        for name, v in resumed.state_dict().items():
            torch.testing.assert_close(v, want[name], rtol=0,
                                       atol=r["atol"])
            err = max(err, float((v - want[name]).abs().max()))
        log(f"train (c): {arch} reduced{' ' + str(kw) if kw else ''} on "
            "the card: "
            f"{r['n_steps']} steps in one go, then failed at step "
            f"{r['fail_at']} and resumed ('{want_line}'); parameters max "
            f"|diff| {err:.3e} (bound atol {r['atol']}); losses "
            f"{[round(h['loss'], 4) for h in hist_ref]}")


def train_launchers():
    """(d) the two launchers, as a user runs them, side by side."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = {"train": ["repro_torch.launch.train", "--arch", "qwen2.5-3b",
                      "--reduced", "--steps", "5"],
            "serve": ["repro_torch.launch.serve", "--arch", "jamba-v0.1-52b",
                      "--reduced", "--paged", "--price-sweep"]}
    procs = {k_: subprocess.Popen([sys.executable, "-m", *c], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for k_, c in cmds.items()}
    want = {"train": "final loss: ", "serve": "price-sweep: "}
    for k_, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        log("\n".join(f"train (d) {k_}: {ln}" for ln in out.splitlines()))
        assert proc.returncode == 0, (k_, err[-3000:])
        assert want[k_] in out, (k_, out)


#: The parallel phase: ranks of a ``torch.distributed`` world sharing the
#: one card over gloo (NCCL refuses two ranks on one GPU), each computing
#: on the card; (a) TP + EP-local jamba at full width on a (data 1, model
#: 4) mesh against the whole model's scatter forward (the bf16 bound of
#: the LM tests), and the reduced jamba in float32; (f) its TP prefill and
#: greedy decode against the whole model's; (b) DP + ZeRO-1 training
#: of qwen2.5-3b at its published widths cut to PAR_TRAIN_LAYERS layers
#: (so that two ranks, each with its weights, float32 gradients, half the
#: moments and one 4,096-token row's activations, fit the card beside each
#: other), against one rank; the reduced qwen in float32, and its elastic
#: restart from 2 ranks onto 1; (c) the streaming sweep over 4 ranks
#: against the stacked 4-shard run; (d) the pipeline and the compressed
#: all-reduce, card against CPU; (e) the EP-local forward as one NCCL rank
#: against scatter, bit for bit; (g) TP + DP + ZeRO-1 training on (2, 2)
#: against (b)'s one rank, and the elastic restore (2, 2) -> (4, 1).
PAR_RANKS, PAR_MESH = 4, (1, 4)
PAR_TIMEOUT_S = 720
PAR_TRAIN_LAYERS, PAR_TRAIN_STEPS, PAR_TRAIN_LR = 8, 3, 1e-4
# the bf16 bound of tests/test_torch_models.py, on the loss and the aux
# loss: tensor parallelism splits every row-parallel product into partial
# sums, each rounded to bf16 before the float32 sum (with experts alone
# over the ranks the forward was bit-exact: the dense leaves were whole)
RTOL_PAR_EP = 3e-2
# The logits: top-k routing is not continuous, so bf16 rounding reroutes
# some tokens (logits about 0.15 apart with free routing, PERF.md); the
# whole model replays the TP ranks' routing, and then TP must be no further
# from the float32 model (the same weights cast up, the same routing) than
# the whole bf16 model is, within this factor (two bf16 roundings of one
# function; on the CPU at d_model 256-1024 the ratio was 1.03)
RATIO_PAR_TP_F32 = 1.25
RTOL_PAR_F32 = 1e-5
RTOL_PAR_TRAIN, RTOL_PAR_TRAIN_F32 = 1e-3, 1e-6
RTOL_PAR_TP_TRAIN, RTOL_PAR_TP_TRAIN_F32 = 3e-2, 1e-5
#: (f)'s decode steps: 16 (cut from 32 to make room for (l) and the
#: examples; each step 155-192 ms a rank)
PAR_TP_PROMPT, PAR_TP_CACHE, PAR_TP_DECODE = (2, 1024), 4096, 16
#: (h) FSDP training: ``launch.dryrun.build_step`` for (g)'s model and
#: batch on (data 2, model 2) in the 4-rank world, held against (g)'s
#: losses by RTOL_PAR_TP_TRAIN; its executed collectives against its
#: capture under a fake (2, 2) group in this process.  (i) FSDP serving:
#: ``build_step`` prefill and decode of (a)'s jamba on (2, 2), fed (f)'s
#: prompt shape, held against the TP-only model on the same mesh (the
#: same weights gathered: bit for bit on the CPU; here within the bf16
#: bound of (a), teacher-forced).  (j) the dry run on the host: its CLI
#: over DRY_CELLS, started at the phase's start beside the ranks.
PAR_FSDP_MESH = (2, 2)
#: (i)'s decode steps: FSDP gathers every layer's weights each step
#: (6.6 GB a rank through host memory under gloo: 14.9 s a step on the
#: H100 machine, PERF.md), which the reference's serving avoids below 7e9
#: bytes a rank; one step (cut from 2) leaves room for (l) and the
#: examples within the script's time
PAR_FSDP_DECODE = 1
DRY_CELLS = (("qwen2.5-3b", "decode_32k", False),
             ("jamba-v0.1-52b", "long_500k", True),
             ("gemma-7b", "train_4k", False),
             ("llama4-maverick-400b-a17b", "train_4k", True))
DRY_TIMEOUT_S = 900
#: (k) ``layout="fsdp_seq"`` (pure FSDP over every rank, the sequence split
#: over ``model``) in the 4-rank world: the kernels alone at rank 3's
#: shapes of jamba's 4,096-token row over 4 model ranks (flash q (2,
#: 1,024, 32, 128) against k / v (2, 4,096, 8, 128) at q_offset 3,072;
#: the scan over 1,024 of 4,096 steps from a state); (a)'s jamba cut to
#: PAR_SEQ_LAYERS layers, both kernels on, on (data 1, model 4): one
#: 4,096-token row, 1,024 a rank,
#: prefilled into a cache of PAR_SEQ_CACHE positions (4,096 and room for
#: the decode steps, divisible by 4) and PAR_SEQ_DECODE greedy decode
#: steps, held against the whole model on rank 0 under (f)'s rule; (g)'s
#: qwen2.5-3b x 8 trained 3 steps on (data 2, model 2) through
#: ``build_step(layout="fsdp_seq")``, held against (g)'s losses as (h) is,
#: its collectives against a capture under a fake (2, 2) group; and
#: ``launch.perf_cell`` over PERF_CELLS in (j)'s thread.
SEQ_FLASH = dict(B=2, S=1024, T=4096, Hq=32, Hkv=8, D=128, o=3072)
SEQ_SCAN = dict(B=2, L=1024, blocks=4, d=8192, N=16)
PAR_SEQ_MESH = (1, 4)
#: (k)'s jamba depth: 4 layers, cut from (a)'s 8 (one attention layer,
#: three mamba, two MoE) to make room for (l) and the examples; each
#: forward gathers every layer's weights through gloo (about 19.9 GB a
#: rank at 8 layers: 41 s a prefill, 37 s a decode step on the H100,
#: PERF.md)
PAR_SEQ_LAYERS = 4
PAR_SEQ_PROMPT, PAR_SEQ_CACHE = (1, 4096), 4352
#: (k)'s decode steps: every step gathers all 26.6 GB of jamba x 8's bf16
#: weights a rank through gloo (about 45 s at the 0.44 GB/s (i) reaches,
#: PERF.md); one step keeps the script under about 1,050 s of its 1,200 s
#: limit
PAR_SEQ_DECODE = 1
#: (l) the reference's decode-cache layout under ``"tp"``
#: (``sharding.cache_block``): qwen2.5-3b at its widths and depth, bf16,
#: flash on, in the 4-rank world.  On (data 1, model 4) its 2 kv heads do
#: not split, so L is split over ``model``: a prefill of 2 x 1,024 tokens;
#: on (data 2, model 2) a batch of 1 does not split over ``data``, so L is
#: split over ``data``: a prefill of 1 x 2,048 tokens; each into a
#: PAR_CACHE_LEN cache, then PAR_CACHE_DECODE greedy decode steps, held
#: against the whole model on rank 0 as (f) is.
PAR_CACHE_ARCH = "qwen2.5-3b"
PAR_CACHE_RUNS = (((1, 4), (2, 1024), None), ((2, 2), (1, 2048), 1))
PAR_CACHE_LEN, PAR_CACHE_DECODE = 4096, 8
#: the greedy tokens of a (l) run that may differ from the whole bf16
#: model's: the most the runs have shown (1 of (1, 4)'s 18, PERF.md), each
#: a near tie by :func:`_cache_whole_compare`'s rule
PAR_CACHE_TIES = 1
PERF_CELLS = (("qwen2.5-3b", "train_4k", "tp"),
              ("qwen2.5-3b", "train_4k", "fsdp_seq"))
PERF_TIMEOUT_S = 600
PAR_PIPE = dict(L=8, D=64, M=6, B=3, seed=0)
PAR_WARM = 4096               # scenarios of the sweeps' untimed first call


def _run_group(cmd, timeout: float, what: str) -> tuple:
    """Run a rank launcher (torchrun or one process) in its own process
    group; on a time-out kill the whole group and raise.  Returns (exit
    code, stdout, stderr)."""
    import os
    import signal

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"{what}: no end after {timeout} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    return proc.returncode, out, err


def run_ranks(cmd, timeout: float, what: str) -> str:
    """:func:`_run_group` that must exit 0; returns its stdout.  On a
    failure the message holds the first traceback (the rank that failed
    first) and the end of the ranks' stderr."""
    rc, out, err = _run_group(cmd, timeout, what)
    first = err.find("Traceback")
    assert rc == 0, (what, rc, err[first:first + 6000] if first >= 0
                     else "", err[-4000:])
    return out


def _torchrun(n: int, *args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(n), *args]


def _rank_results(out_dir, n: int, tag: str) -> list:
    return [json.loads((out_dir / f"{tag}{r}.json").read_text())
            for r in range(n)]


def phase_parallel(torch, np, pt, card, cb):
    """The parallel layer over ranks on the card; returns each kernel
    wrapper's launches on its path (summed over the ranks)."""
    import dataclasses
    import pickle
    import tempfile

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out = pathlib.Path(tempfile.mkdtemp(prefix="parallel-"))
    dry = _start_dryrun(out / "dryrun")          # (j), beside the ranks
    cb_path = out / "bundle.pkl"
    # a fresh instance: the bundle without its cached device tensors
    cb_path.write_bytes(pickle.dumps(dataclasses.replace(cb)))
    log(f"parallel: {PAR_RANKS} ranks share the card over gloo (each "
        f"computes on the card; the collectives cross host memory: this "
        f"prices no NVLink or NCCL transport); the parent holds "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")

    # which collectives gloo takes from CUDA tensors (the transport's
    # routes rest on it)
    from repro_torch.parallel import transport
    t0 = time.perf_counter()
    rc, _, err = _run_group(_torchrun(2, str(ROOT / "chip_smoke.py"),
                                      "--rank", "probe", str(out)), 120,
                            "gloo probe")
    seen = _rank_results(out, 2, "probe")
    direct = {k for k, v in seen[0].items() if v == "ok"}
    assert set(transport.GLOO_CUDA) | {"all_gather_single",
                                       "reduce_scatter_single"} <= direct, \
        (direct, seen)
    assert rc != 0 and all(r["send/recv"] == "started" for r in seen), \
        (rc, seen)
    cause = [ln for ln in err.splitlines() if "gloo::IoException" in ln
             or "writev" in ln][:1]
    log(f"parallel: gloo with CUDA tensors (2 ranks on the card) takes "
        f"{sorted(direct)}; the list all-to-all: {seen[0]['all_to_all']}; "
        f"a send / receive of a CUDA tensor ended the ranks (exit {rc}: "
        f"{cause}), so that route is staged through pinned host memory "
        f"({time.perf_counter() - t0:.1f} s)")

    # (k) the offset and state kernels alone, at rank 3's shapes
    seq_kernels = parallel_seq_kernels(torch, np, card)

    # (a), (c), (d): one 4-rank world
    t0 = time.perf_counter()
    text = run_ranks(_torchrun(PAR_RANKS, str(ROOT / "chip_smoke.py"),
                               "--rank", "world", str(out)),
                     PAR_TIMEOUT_S, "parallel world")
    wall = time.perf_counter() - t0
    ranks = _rank_results(out, PAR_RANKS, "world")
    for ln in text.splitlines():
        if ln.startswith("parallel"):
            log(ln)
    launches = {"fused_bracket_segsum": 0, "segment_sum": 0,
                "halo_exchange": 0, "flash_attention": 0, "mamba_scan": 0,
                "stencil27": 0}
    errs = {"flash_attention": 0.0, "mamba_scan": 0.0,
            "fused_bracket_segsum": 0.0}
    for r in ranks:
        ep = r["ep"]
        for k in launches:
            launches[k] += ep["launches"].get(k, 0) \
                + ep["f_launches"].get(k, 0) \
                + r["sweep"]["launches"].get(k, 0)
        errs["flash_attention"] = max(errs["flash_attention"],
                                      ep["err_flash"], ep["f_err_flash"])
        errs["mamba_scan"] = max(errs["mamba_scan"], ep["err_scan"],
                                 ep["f_err_scan"])
        errs["fused_bracket_segsum"] = max(errs["fused_bracket_segsum"],
                                           r["sweep"]["err_bracket"])
        assert ep["launches"]["flash_attention"] == 1, ep["launches"]
        assert ep["launches"]["mamba_scan"] == 7, ep["launches"]
        assert ep["fwd_allreduces"] == ep["tp_allreduces"], ep
        for k in ("flash_attention", "mamba_scan"):
            assert ep["f_launches"][k] == ep["launches"][k], ep
        log(f"parallel (a) [{card}] rank {r['rank']}: TP + EP, experts "
            f"{ep['experts']}, {ep['params'] / 1e9:.3f} B parameters "
            f"({ep['param_bytes'] / 1e9:.3f} GB) of {ep['whole_params'] / 1e9:.3f} B, built in "
            f"{ep['build_s']:.2f} s; forward {ep['fwd_ms']:.2f} ms (median "
            f"of 3, ranks aligned by a barrier; first {ep['first_ms']:.2f} "
            f"ms); peak {ep['peak_bytes'] / 1e9:.3f} GB; collectives per "
            f"forward (calls, bytes put in) {ep['fwd_collectives']}; "
            f"launches {ep['launches']}; kernel shapes {ep['shapes']}; "
            f"holds: flash {ep['err_flash']:.3e} (rel norm "
            f"{ep['rel_flash']:.3e}), scan {ep['err_scan']:.3e}")
        log(f"parallel (f) [{card}] rank {r['rank']}: TP prefill of "
            f"{PAR_TP_PROMPT[0]} x {PAR_TP_PROMPT[1]} tokens into a "
            f"{PAR_TP_CACHE} cache {ep['prefill_ms']:.2f} ms (median of 2 "
            f"after a first of {ep['prefill_first_ms']:.2f} ms), "
            f"{PAR_TP_DECODE} greedy decode steps {ep['decode_ms']:.2f} ms "
            f"a step (median), {ep['decode_collectives']} collectives a "
            f"step; launches {ep['f_launches']}; holds: flash "
            f"{ep['f_err_flash']:.3e}, scan {ep['f_err_scan']:.3e}")
    c0 = ranks[0]["ep"]
    log(f"parallel (a): TP + EP loss {c0['loss']:.6f} aux {c0['aux']:.6f} "
        f"against the whole model's scatter forward {c0['loss_whole']:.6f} "
        f"/ {c0['aux_whole']:.6f}: loss rel {c0['loss_rel']:.3e}, aux rel "
        f"{c0['aux_rel']:.3e} (bound {RTOL_PAR_EP}); logits relative norm "
        f"{c0['logits_rel']:.3e} with free routing (the whole model routes "
        f"{c0['rerouted']} of {c0['routed']} tokens otherwise, per MoE "
        f"layer), {c0['same_rel']:.3e} with the TP ranks' routing; against "
        f"the float32 model (same weights, same routing): TP "
        f"{c0['tp_f32']:.3e}, the whole bf16 model {c0['whole_f32']:.3e} "
        f"(bound: TP within {RATIO_PAR_TP_F32} x the whole's + "
        f"{RTOL_PAR_F32}); whole model "
        f"peak {c0['whole_peak_bytes'] / 1e9:.3f} GB (float32: "
        f"{c0['f32_peak_bytes'] / 1e9:.3f} GB); float32 reduced jamba TP + "
        f"EP on {PAR_RANKS} ranks: max rel "
        f"{max(r['ep_f32'] for r in ranks):.3e} (bound {RTOL_PAR_F32})")
    log(f"parallel (f): the prefill's logits with free routing "
        f"{c0['f_free_rel']:.3e} from the whole model's; all "
        f"{1 + PAR_TP_DECODE} steps' logits, the whole model fed the same "
        f"tokens "
        f"and the TP ranks' routing ({c0['f_rerouted']} token-layers "
        f"rerouted): {c0['f_same_rel']:.3e}; against the float32 model: TP "
        f"{c0['f_tp_f32']:.3e}, the whole bf16 model "
        f"{c0['f_whole_f32']:.3e} (bound: within {RATIO_PAR_TP_F32} x); "
        f"greedy tokens that agree {c0['f_agree']} of {c0['f_tokens']}; the "
        f"whole model's prefill {c0['f_whole_prefill_ms']:.2f} ms, decode "
        f"step {c0['f_whole_decode_ms']:.2f} ms")
    for key in ("loss_rel", "aux_rel"):
        assert c0[key] <= RTOL_PAR_EP, (key, c0[key])
    for tp, whole in (("tp_f32", "whole_f32"), ("f_tp_f32", "f_whole_f32")):
        assert c0[tp] <= RATIO_PAR_TP_F32 * c0[whole] + RTOL_PAR_F32, \
            (tp, c0[tp], c0[whole])
    assert max(r["ep_f32"] for r in ranks) <= RTOL_PAR_F32

    # (c) against the stacked 4-shard run in this process
    from repro_torch.core import ExecPlan
    seed = pt.adaptive_sample(pt.ModelParams.multinode(), S_STREAM, seed=1,
                              mpi_transfer=["hockney", "loggp"],
                              cxl_lat_ns=(250, 700),
                              cxl_atomic_lat_ns=(300, 800))
    plan = ExecPlan.parse(f"{STREAM_PLAN},devices={PAR_RANKS}")
    pt.price(cb, seed.subset(np.arange(PAR_WARM)), plan=plan)    # warm-up
    t0 = time.perf_counter()
    stacked = pt.price(cb, seed, plan=plan)
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t0
    got = np.load(out / "sweep.npz")
    assert np.array_equal(got["indices"], stacked.indices)
    np.testing.assert_allclose(got["speedups"], stacked.speedups,
                               rtol=RTOL_PATH, atol=0)
    np.testing.assert_allclose(got["gain_ns"], stacked.result.gain_ns,
                               rtol=RTOL_PATH, atol=0)
    agg = stacked.aggregates
    gaps = {}
    for k in ("count", "speedup_mean", "speedup_min", "speedup_max", "hist",
              "n_beneficial", "gain_sum"):
        a, b = np.asarray(got[k], np.float64), np.asarray(getattr(agg, k),
                                                          np.float64)
        gaps[k] = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
        assert gaps[k] == 0.0 or k not in ("count", "hist", "n_beneficial")
        assert gaps[k] <= 1e-12, (k, gaps[k])
    from repro_torch.core.sweep_kernel import DIST_CHUNK_DEFAULT
    n_chunks = 2 * -(-S_STREAM // DIST_CHUNK_DEFAULT)
    sw = [r["sweep"] for r in ranks]
    for s in sw:
        assert s["launches"]["fused_bracket_segsum"] == n_chunks + 1, s
        assert s["equal"], s
    rank_s = max(s["seconds"] for s in sw)
    log(f"parallel (c) [{card}]: {plan.to_string()} over {PAR_RANKS} ranks: "
        f"{2 * S_STREAM} scenarios in {rank_s:.4f} s (slowest rank) = "
        f"{2 * S_STREAM / rank_s:.1f} scenarios/s; stacked on one process "
        f"{stacked_s:.4f} s = {2 * S_STREAM / stacked_s:.1f} scenarios/s; "
        f"bracket launches per rank {n_chunks + 1} ({n_chunks} chunks + the "
        f"exact pass), each rank's first chunk held against the plain "
        f"pricing (max_abs_err {errs['fused_bracket_segsum']:.3e}); indices "
        f"equal, speedups and gains within {RTOL_PATH}; aggregates' largest "
        f"relative gap {max(gaps.values()):.3e} ({gaps}); every rank the "
        f"same result")

    # (d)
    for r in ranks:
        p = r["pipe"]
        # the reference pipeline test's bounds
        assert p["pipe_out"] <= 1e-5 and p["pipe_grad"] <= 1e-4, p
        assert p["psum_payload_equal"] and p["psum_out"] <= 1e-6, p
    log(f"parallel (d): pipeline_apply over {PAR_RANKS} stages (L, D, M, B "
        f"= {PAR_PIPE['L']}, {PAR_PIPE['D']}, {PAR_PIPE['M']}, "
        f"{PAR_PIPE['B']}) on the card against the CPU: output "
        f"{max(r['pipe']['pipe_out'] for r in ranks):.3e}, gradients "
        f"{max(r['pipe']['pipe_grad'] for r in ranks):.3e}; compressed_psum "
        f"5 steps: payloads and scales equal, sums "
        f"{max(r['pipe']['psum_out'] for r in ranks):.3e}")
    routes = {}
    for r in ranks:
        for k, n in r["routes"].items():
            routes[k] = routes.get(k, 0) + n
    log(f"parallel: collective routes over the {PAR_RANKS} ranks (calls): "
        f"{routes}; host-staged: "
        f"{sorted(k for k in routes if k.endswith(' host'))}; world "
        f"{wall:.1f} s of wall time")

    # (e) one NCCL rank
    t0 = time.perf_counter()
    run_ranks(_torchrun(1, str(ROOT / "chip_smoke.py"), "--rank", "nccl",
                        str(out)), PAR_TIMEOUT_S, "nccl rank")
    e = _rank_results(out, 1, "nccl")[0]
    assert e["equal"] and e["aux_equal"], e
    for k in launches:
        launches[k] += e["launches"].get(k, 0)
    errs["flash_attention"] = max(errs["flash_attention"], e["err_flash"])
    errs["mamba_scan"] = max(errs["mamba_scan"], e["err_scan"])
    log(f"parallel (e): the EP-local forward as one NCCL rank (model axis "
        f"1): logits bit-identical to scatter {e['equal']}, aux "
        f"{e['aux_equal']}; launches {e['launches']}; routes {e['routes']}; "
        f"{time.perf_counter() - t0:.1f} s")

    # (b) training through the launcher, then (h) against (g)
    g_losses = parallel_train(card)
    parallel_fsdp(torch, card, ranks, g_losses)
    for k, n in parallel_seq(torch, card, ranks, g_losses).items():
        launches[k] += n
    launches["flash_attention"] += parallel_tp_cache(card, ranks)
    for r in ranks:
        errs["flash_attention"] = max(errs["flash_attention"],
                                      r["seq_serve"]["err_flash"])
        errs["mamba_scan"] = max(errs["mamba_scan"],
                                 r["seq_serve"]["err_scan"])
        errs["flash_attention"] = max(
            [errs["flash_attention"]]
            + [k["err_flash"] for k in r["tp_cache"]["runs"]])
    _finish_dryrun(torch, card, dry)
    log(f"parallel: phase {time.perf_counter() - t_phase:.1f} s")
    return launches, errs, seq_kernels


# --------------------------------------------------------------------------
# 14b. the port's examples on the card
# --------------------------------------------------------------------------
#: each example's ``main`` at its smallest arguments (``--device`` is the
#: card by default); serve_lm with the reduced jamba, whose prefills run
#: both LM kernels
EXAMPLE_RUNS = (
    ("quickstart", ()), ("stencil_advisor", ()), ("hpcg_analysis", ()),
    ("sweep_quickstart", ()),
    ("serve_lm", ("--arch", "jamba-v0.1-52b")),
    ("serve_lm", ("--arch", "jamba-v0.1-52b", "--continuous")),
    ("train_lm", ("--small", "--steps", "20", "--log-every", "5")))


def phase_examples(card, counters) -> dict:
    """14b. Every example of ``repro_torch.examples`` in this process on
    the card: each must return 0 (its output kept, its last line logged);
    the sweep, halo, operator and LM kernels must have launched.  Returns each
    kernel wrapper's launches over the phase."""
    import contextlib
    import io

    for c in counters.values():
        c.launches = 0
    t_phase = time.perf_counter()
    for name, args in EXAMPLE_RUNS:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(list(args))
        out = buf.getvalue().strip().splitlines()
        assert rc == 0, (name, args, out[-20:])
        log(f"examples [{card}] {name} {' '.join(args)}: exit {rc} in "
            f"{time.perf_counter() - t0:.1f} s; last line: {out[-1]}")
    launches = {k: c.launches for k, c in counters.items()}
    for k in ("fused_bracket_segsum", "halo_exchange", "flash_attention",
              "mamba_scan", "stencil27"):
        assert launches[k] > 0, (k, launches)
    log(f"examples: launches {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _train_runs(cmd_1, cmd_2):
    """(1-rank summary, [2-rank summaries]) of the train launcher."""
    one = [json.loads(ln) for ln in run_ranks(
        [sys.executable, "-m", "repro_torch.launch.train", *cmd_1],
        PAR_TIMEOUT_S, "train 1 rank").splitlines() if ln.startswith("{")]
    two = [json.loads(ln) for ln in run_ranks(
        _torchrun(2, "-m", "repro_torch.launch.train", *cmd_2),
        PAR_TIMEOUT_S, "train 2 ranks").splitlines() if ln.startswith("{")]
    assert len(one) == 1 and sorted(d["rank"] for d in two) == [0, 1]
    return one[0], sorted(two, key=lambda d: d["rank"])


def parallel_train(card):
    """(b) DP + ZeRO-1 training on 2 gloo ranks against 1 rank, at full
    width and in float32, and the elastic restart; (g) the same launcher
    tensor parallel on (2, 2) against (b)'s one rank, and its elastic
    restore onto (4, 1)."""
    import tempfile

    base = ["--arch", "qwen2.5-3b", "--layers", str(PAR_TRAIN_LAYERS),
            "--seq", "4096", "--batch", "2", "--steps", str(PAR_TRAIN_STEPS),
            "--lr", str(PAR_TRAIN_LR), "--log-every", "1", "--summary"]
    dp = ["--mesh", "2,1", "--backend", "gloo"]
    one, two = _train_runs(base + ["--micro", "2"], base + dp)
    one_full = one
    l1 = [h["loss"] for h in one["history"]]
    for d in two:
        l2 = [h["loss"] for h in d["history"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
        assert rel <= RTOL_PAR_TRAIN, (l1, l2)
        mb1, mb2 = one["history"][0]["moment_bytes"], \
            d["history"][0]["moment_bytes"]
        assert 2 * mb2 == mb1, (mb1, mb2)
        step = statistics.median(h["step_s"] for h in d["history"][1:])
        log(f"parallel (b) [{card}] qwen2.5-3b x {PAR_TRAIN_LAYERS} layers "
            f"bf16, 2 x 4096 tokens, rank {d['rank']} of 2 (gloo, ZeRO-1): "
            f"losses {[round(x, 6) for x in l2]}, max rel to 1 rank "
            f"{rel:.3e} (bound {RTOL_PAR_TRAIN}); step {step:.4f} s (median "
            f"of steps 2-{PAR_TRAIN_STEPS}); moment bytes {mb2:,} (1 rank "
            f"{mb1:,}); peak {(d['peak_bytes'] or 0) / 1e9:.3f} GB")
    step1 = statistics.median(h["step_s"] for h in one["history"][1:])
    log(f"parallel (b) [{card}] 1 rank (2 microbatches): losses "
        f"{[round(x, 6) for x in l1]}; step {step1:.4f} s; peak "
        f"{(one['peak_bytes'] or 0) / 1e9:.3f} GB")

    # float32 reduced, and the elastic restart: 2 ranks save, 1 resumes
    ck = tempfile.mkdtemp(prefix="elastic-")
    small = ["--arch", "qwen2.5-3b", "--reduced", "--seq", "32", "--batch",
             "2", "--log-every", "1", "--summary"]
    one, two = _train_runs(small + ["--micro", "2", "--steps", "4"],
                           small + dp + ["--steps", "3", "--ckpt-dir", ck,
                                         "--ckpt-every", "1"])
    l1 = [h["loss"] for h in one["history"]]
    rel = max(abs(a - b) / abs(b) for d in two
              for a, b in zip([h["loss"] for h in d["history"]], l1))
    assert rel <= RTOL_PAR_TRAIN_F32, rel
    resumed = [json.loads(ln) for ln in run_ranks(
        [sys.executable, "-m", "repro_torch.launch.train", *small, "--micro",
         "2", "--steps", "4", "--ckpt-dir", ck], PAR_TIMEOUT_S,
        "train resume").splitlines() if ln.startswith("{")][0]
    (last,) = resumed["history"]
    gap = abs(last["loss"] - l1[3]) / abs(l1[3])
    assert last["step"] == 3 and gap <= RTOL_PAR_TRAIN_F32, (last, l1)
    log(f"parallel (b): reduced qwen2.5-3b float32 on 2 ranks against 1: "
        f"max rel {rel:.3e} (bound {RTOL_PAR_TRAIN_F32}); saved on 2 ranks "
        f"at step 2, resumed on 1: step 3 loss {last['loss']:.8f} against "
        f"the uninterrupted {l1[3]:.8f} (rel {gap:.3e})")
    return parallel_tp_train(card, base, one_full, small, l1)


def _four_ranks(args, what: str) -> list:
    """The 4 ranks' summaries of the train launcher under torchrun."""
    four = [json.loads(ln) for ln in run_ranks(
        _torchrun(4, "-m", "repro_torch.launch.train", *args),
        PAR_TIMEOUT_S, what).splitlines() if ln.startswith("{")]
    assert sorted(d["rank"] for d in four) == [0, 1, 2, 3], four
    return sorted(four, key=lambda d: d["rank"])


def parallel_tp_train(card, base, one, small, l1_small):
    """(g) TP + DP + ZeRO-1 training through the launcher on (data 2, model
    2): qwen2.5-3b at its widths cut to 8 layers against (b)'s one rank;
    the reduced qwen in float32 against its one rank, its checkpoint
    restored on (4, 1) and saved again byte for byte."""
    import filecmp
    import shutil
    import tempfile

    tp = ["--mesh", "2,2", "--backend", "gloo"]
    t0 = time.perf_counter()
    four = _four_ranks(base + tp, "train TP")
    l1 = [h["loss"] for h in one["history"]]
    mb1 = one["history"][0]["moment_bytes"]
    for d in four:
        l4 = [h["loss"] for h in d["history"]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(l4, l1))
        assert rel <= RTOL_PAR_TP_TRAIN, (l1, l4)
        mb = d["history"][0]["moment_bytes"]
        assert 2 * mb < mb1, (mb, mb1)
        step = statistics.median(h["step_s"] for h in d["history"][1:])
        log(f"parallel (g) [{card}] qwen2.5-3b x {PAR_TRAIN_LAYERS} layers "
            f"bf16, 2 x 4096 tokens, rank {d['rank']} of 4 on (data 2, model "
            f"2) (gloo, TP + ZeRO-1): losses {[round(x, 6) for x in l4]}, "
            f"max rel to 1 rank {rel:.3e} (bound {RTOL_PAR_TP_TRAIN}); step "
            f"{step:.4f} s (median of steps 2-{PAR_TRAIN_STEPS}); moment "
            f"bytes {mb:,} (1 rank {mb1:,}); peak "
            f"{(d['peak_bytes'] or 0) / 1e9:.3f} GB")
    log(f"parallel (g): {time.perf_counter() - t0:.1f} s of wall time")
    g_losses = [h["loss"] for h in four[0]["history"]]

    ck = pathlib.Path(tempfile.mkdtemp(prefix="tp-elastic-"))
    four = _four_ranks(small + tp + ["--steps", "3", "--ckpt-dir",
                                     str(ck / "a"), "--ckpt-every", "1"],
                       "train TP reduced")
    rel = max(abs(a - b) / abs(b) for d in four
              for a, b in zip([h["loss"] for h in d["history"]], l1_small))
    assert rel <= RTOL_PAR_TP_TRAIN_F32, rel
    shutil.copytree(ck / "a", ck / "b")
    _four_ranks(small + ["--mesh", "4,1", "--backend", "gloo", "--steps",
                         "3", "--ckpt-dir", str(ck / "b")],
                "train restore on (4, 1)")
    a, b = ck / "a" / "step_00000002", ck / "b" / "step_00000002"
    files = sorted(p.name for p in a.iterdir())
    same, differ, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert len(same) == len(files) > 3 and not differ and not errors, \
        (differ, errors)
    log(f"parallel (g): reduced qwen2.5-3b float32 on (2, 2) against 1 "
        f"rank: max rel {rel:.3e} (bound {RTOL_PAR_TP_TRAIN_F32}); its step "
        f"2 checkpoint restored on (4, 1) and saved again: {len(same)} of "
        f"{len(files)} files equal byte for byte")
    return g_losses


def _kernel_counts() -> dict:
    """Every kernel wrapper's launch counter in this process."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import halo_exchange as hx
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import sweep_bracket as sb
    from repro_torch.kernels.stencil27 import apply_27pt
    return {"fused_bracket_segsum": sb.fused_bracket_segsum.launches,
            "segment_sum": sb.segment_sum.launches,
            "halo_exchange": hx.ring_halo_exchange.launches,
            "flash_attention": fa.flash_attention.launches,
            "mamba_scan": ms.mamba_scan.launches,
            "stencil27": apply_27pt.launches}


def _fsdp_train_cfg():
    """(g)'s model and batch: qwen2.5-3b at its widths, PAR_TRAIN_LAYERS
    layers, 2 x 4,096 tokens, (g)'s optimizer."""
    from repro_torch import configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import AdamWConfig
    return (configs.get_arch("qwen2.5-3b").replace(n_layers=PAR_TRAIN_LAYERS),
            ShapeConfig("cli", "train", 4096, 2),
            AdamWConfig(lr=PAR_TRAIN_LR, total_steps=PAR_TRAIN_STEPS))


def parallel_fsdp(torch, card, ranks, g_losses):
    """(h) and (i), from the world's ranks: (h)'s losses against (g)'s
    (the same model, batch and optimizer through the launcher, TP only),
    its executed collectives against the capture of the same step under a
    fake (2, 2) group here; (i)'s trajectory against the TP-only model's.
    No kernel launches in either, here or in the ranks."""
    import torch.distributed as dist
    from repro_torch.core import graph
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_ranks, make_mesh
    from repro_torch.parallel import transport

    for r in ranks:
        h = r["fsdp_train"]
        assert h["meta"]["fsdp"] and h["meta"]["n_micro"] == 1, h["meta"]
        assert h["launches"] == h["launches_before"], h
        rel = max(abs(a - b) / abs(b) for a, b in zip(h["losses"], g_losses))
        assert rel <= RTOL_PAR_TP_TRAIN, (h["losses"], g_losses)
        log(f"parallel (h) [{card}] rank {r['rank']}: build_step "
            f"{h['meta']} on {PAR_FSDP_MESH} (FSDP + TP + ZeRO-1), "
            f"{h['params'] / 1e9:.3f} B parameters a rank "
            f"({h['param_bytes']:,} bytes; (g): 0.619 B), moments "
            f"{h['moment_bytes']:,} bytes, built in {h['build_s']:.2f} s; "
            f"losses {[round(x, 6) for x in h['losses']]}, max rel to "
            f"(g)'s {rel:.3e} (bound {RTOL_PAR_TP_TRAIN}); step "
            f"{statistics.median(h['step_s'][1:]):.4f} s (median of steps "
            f"2-{PAR_TRAIN_STEPS}; first {h['step_s'][0]:.4f} s); peak "
            f"{h['peak_bytes'] / 1e9:.3f} GB; collectives of step 1 by "
            f"route {h['routes']}")
    # the same step captured under a fake (2, 2) group: rank 0's view
    cfg, shape, opt = _fsdp_train_cfg()
    counts = _kernel_counts()
    t0 = time.perf_counter()
    init_fake_ranks(PAR_RANKS)
    try:
        mesh = make_mesh(PAR_FSDP_MESH, ("data", "model"), "cpu")
        step, args, meta = dryrun.build_step(cfg, shape, mesh, opt_cfg=opt,
                                             device="cpu", abstract=True)
        captured = graph.capture(step, *args, fold=True)
        want = transport.as_counted(captured.collectives())
    finally:
        dist.destroy_process_group()
    assert _kernel_counts() == counts
    got = {k: tuple(v) for k, v in ranks[0]["fsdp_train"]["executed"]
           .items()}
    assert got == want, (got, want)
    log(f"parallel (h): rank 0's collectives of step 1 (calls, bytes put "
        f"in) {got}, equal to the step's capture under a fake "
        f"{PAR_FSDP_MESH} group ({sum(captured.ops.values()):,} ops, "
        f"{time.perf_counter() - t0:.1f} s on the host)")

    for r in ranks:
        i = r["fsdp_serve"]
        assert i["meta_prefill"]["fsdp"] and i["meta_decode"]["fsdp"], i
        assert i["launches"] == i["launches_before"], i
        assert i["rel"] <= RTOL_PAR_EP, i["rel"]
        log(f"parallel (i) [{card}] rank {r['rank']}: build_step prefill "
            f"and decode of {LM_ARCH} x {LM_LAYERS} (meta "
            f"{i['meta_prefill']} / {i['meta_decode']}) on "
            f"{PAR_FSDP_MESH}, {i['params'] / 1e9:.3f} B parameters a rank "
            f"(TP only: {i['tp_params'] / 1e9:.3f} B); its row of "
            f"{PAR_TP_PROMPT} prompt tokens into a {PAR_TP_CACHE} cache "
            f"{i['prefill_ms']:.2f} ms (one prefill; TP only "
            f"{i['tp_prefill_ms']:.2f} ms), "
            f"{PAR_FSDP_DECODE} decode steps fed the TP-only run's tokens "
            f"{i['decode_ms']:.2f} ms a step (TP only "
            f"{i['tp_decode_ms']:.2f} ms); against the TP-only model on "
            f"the same mesh: {i['equal_steps']} of {PAR_FSDP_DECODE + 1} "
            f"steps' logits bit for bit, relative norm {i['rel']:.3e} "
            f"(bound {RTOL_PAR_EP}), greedy tokens that agree "
            f"{i['agree']} of {PAR_FSDP_DECODE + 1}; peak "
            f"{i['peak_bytes'] / 1e9:.3f} GB")


def _start_dryrun(out_dir):
    """(j): the dry run's CLI over DRY_CELLS, one process after another in
    a thread of this process, its records under ``out_dir``."""
    import threading
    out_dir.mkdir(parents=True, exist_ok=True)
    res = {"cells": [], "perf": [], "error": None}

    def run():
        t0 = time.perf_counter()
        try:
            for arch, shape, multi in DRY_CELLS:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out",
                       str(out_dir)] + (["--multi-pod"] if multi else [])
                t1 = time.perf_counter()
                rc, stdout, err = _run_group(cmd, DRY_TIMEOUT_S,
                                             f"dry run {arch} {shape}")
                res["cells"].append((arch, shape, multi, rc, stdout,
                                     err[-3000:],
                                     time.perf_counter() - t1))
            for arch, shape, layout in PERF_CELLS:      # (k)'s perf_cell
                cmd = [sys.executable, "-m", "repro_torch.launch.perf_cell",
                       "--arch", arch, "--shape", shape, "--layout", layout]
                t1 = time.perf_counter()
                rc, stdout, err = _run_group(cmd, PERF_TIMEOUT_S,
                                             f"perf_cell {arch} {layout}")
                res["perf"].append((arch, shape, layout, rc, stdout,
                                    err[-3000:], time.perf_counter() - t1))
        except Exception as e:                  # reported by _finish
            res["error"] = repr(e)
        res["wall_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, res, out_dir


def _finish_dryrun(torch, card, dry):
    """(j): wait for the CLI, print its time and one line a cell (the
    roofline terms are modelled on the H100's spec, not measured)."""
    thread, res, out_dir = dry
    counts = _kernel_counts()
    thread.join(DRY_TIMEOUT_S * len(DRY_CELLS)
                + PERF_TIMEOUT_S * len(PERF_CELLS))
    assert not thread.is_alive(), "the dry run did not end"
    assert res["error"] is None, res["error"]
    assert _kernel_counts() == counts
    log(f"parallel (j): the dry run's CLI over {len(DRY_CELLS)} cells took "
        f"{res['wall_s']:.1f} s on this machine's host, beside the ranks "
        f"(" + ", ".join(f"{a} x {s}{' (2 pods)' if m else ''} "
                         f"{t:.1f} s" for a, s, m, _, _, _, t
                         in res["cells"]) + ")")
    for arch, shape, multi, rc, stdout, err, _ in res["cells"]:
        assert rc == 0, (arch, shape, rc, err)
        mesh = "2x16x16" if multi else "16x16"
        rec = json.loads((out_dir / mesh / f"{arch}__{shape}.json")
                         .read_text())
        assert rec["status"] == "ok", rec
        r, m = rec["roofline"], rec["memory"]
        assert all(r[k] >= 0 for k in ("compute_s", "memory_s",
                                       "collective_s")), r
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith("[ok]"))
        log(f"parallel (j) [modelled on the H100 spec, not measured]: "
            f"{line[7:]}; fsdp {rec['fsdp']}, optimizer "
            f"{rec.get('optimizer', '-')}, n_micro {rec['n_micro']}, live "
            f"{m['live_bytes'] / 1e9:.2f} GB a rank (analytic "
            f"{m['analytic_live_bytes']['total'] / 1e9:.2f} GB), fits 80 "
            f"GB {m['fits_hbm']}, collectives "
            f"{ {k: v['count'] for k, v in rec['collectives'].items()} }")
    keys = {"overrides", "n_micro", "compute_s", "memory_s", "collective_s",
            "dominant", "wire_GB", "live_device_GB", "roofline_fraction",
            "useful_ratio", "compile_s"}
    for arch, shape, layout, rc, stdout, err, t in res["perf"]:
        assert rc == 0, (arch, shape, layout, rc, err)
        got = json.loads(stdout)
        assert set(got) == keys, got
        log(f"parallel (k) [modelled on the H100 spec, not measured]: "
            f"python -m repro_torch.launch.perf_cell --arch {arch} --shape "
            f"{shape} --layout {layout} on (16, 16): {t:.1f} s on the host; "
            f"{json.dumps(got)}")


# -------------------------------------------------------------------- (k)
def parallel_seq_kernels(torch, np, card) -> dict:
    """(k) both LM kernels alone at rank 3's shapes of jamba's 4,096-token
    row over 4 model ranks, each against its plain version: flash at
    ``q_offset`` (and against the whole causal call's rows, bit for bit:
    the block starts on a 128-row tile), the scan from a nonzero ``h0``
    (and the four-block two-pass combine against the whole-sequence
    scan); their device times beside their bounds, the plain versions and
    (flash) SDPA with the offset's mask.  Returns the ``kernels`` line's
    rows: ``{name: (key, row)}``."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    dev = torch.device(DEVICE)
    f = SEQ_FLASH
    B, S, T, Hq, Hkv, D, o = (f[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                             "D", "o"))
    g = torch.Generator(device=dev).manual_seed(LM_SEED + 3)
    qf = torch.randn((B, T, Hq, D), generator=g, device=dev,
                     dtype=torch.bfloat16)
    k = torch.randn((B, T, Hkv, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((B, T, Hkv, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    q = qf[:, o:o + S].contiguous()
    before = fa.flash_attention.route_launches["sm90"]
    with torch.inference_mode():
        out = fa.flash_attention(q, k, v, block_q=S, block_k=T, q_offset=o)
        whole = fa.flash_attention(qf, k, v, block_q=T, block_k=T)
        torch.cuda.synchronize()
        assert fa.flash_attention.route_launches["sm90"] == before + 2
        f_err, f_rel = _hold_flash(torch, (q, k, v), {"q_offset": o}, out)
        same_rows = bool(torch.equal(out, whole[:, o:]))
        assert same_rows, "the offset call's rows differ from the whole's"
        del whole, qf
        pairs = S * o + S * (S + 1) // 2
        f_ops = 4 * B * Hq * D * pairs
        f_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        f_bound = max(f_bytes / HBM_BYTES_S, f_ops / BF16_OPS_S) * 1e3
        f_by = "bytes" if f_bytes / HBM_BYTES_S >= f_ops / BF16_OPS_S \
            else "operations"
        f_ms = device_ms(torch, lambda: fa.flash_attention(
            q, k, v, block_q=S, block_k=T, q_offset=o), reps=10,
            name="attn_sm90_kernel", floor=f_bound)
        f_plain = device_ms(torch, lambda: fa.attention_ref(
            q, k, v, q_offset=o), reps=3, floor=f_bound)
        mask = torch.arange(T, device=dev)[None, :] <= (
            o + torch.arange(S, device=dev))[:, None]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        f_lib = device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True), reps=10,
            floor=f_bound)
    del q, k, v, out, qt, kt, vt, mask
    log(f"parallel (k) [{card}]: flash_attention q ({B}, {S}, {Hq}, {D}) "
        f"against k/v ({B}, {T}, {Hkv}, {D}) bf16 at q_offset {o} (rank 3 "
        f"of 4 at 4,096 positions): ok, max_abs_err={f_err:.3e} (rel norm "
        f"{f_rel:.3e}); its rows of the whole causal call bit for bit "
        f"{same_rows}; device time per call (profiler): attn_sm90_kernel "
        f"{f_ms:.4f} ms, plain {f_plain:.4f} ms, "
        f"scaled_dot_product_attention with the offset's mask {f_lib:.4f} "
        f"ms; bound {f_bound:.4f} ms ({f_by}: {f_ops:.4e} operations, "
        f"{f_bytes} bytes)")

    c = SEQ_SCAN
    B, L, n, d, N = (c[k] for k in ("B", "L", "blocks", "d", "N"))
    rng = np.random.default_rng(LM_SEED + 4)

    def arr(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    x, dt, Bt, Ct = (arr(rng.normal(size=(B, n * L, d))),
                     arr(np.abs(rng.normal(0.05, 0.02, size=(B, n * L, d)))),
                     arr(rng.normal(size=(B, n * L, N))),
                     arr(rng.normal(size=(B, n * L, N))))
    A, Dv = arr(-np.abs(rng.normal(1, 0.3, size=(d, N)))), \
        arr(rng.normal(size=(d,)))
    h0 = arr(rng.normal(size=(B, d, N)))
    blk = [t[:, (n - 1) * L:].contiguous() for t in (x, dt, Bt, Ct)]
    before = ms.mamba_scan.launches
    with torch.inference_mode():
        y, h = ms.mamba_scan(*blk, A, Dv, chunk=L, h0=h0)
        torch.cuda.synchronize()
        assert ms.mamba_scan.launches == before + 1
        s_err, _ = _hold_scan(torch, (*blk, A, Dv), {"h0": h0}, (y, h))
        # the two passes of models.mamba over n blocks, on the kernel
        ends, ys = [], []
        for r in range(n):
            part = [t[:, r * L:(r + 1) * L] for t in (x, dt, Bt, Ct)]
            _, he = ms.mamba_scan(*part, A, Dv, chunk=L)
            ends.append((he, torch.exp(A * part[1].sum(1)[..., None])))
        h_in = torch.zeros_like(h0)
        for r in range(n):
            part = [t[:, r * L:(r + 1) * L] for t in (x, dt, Bt, Ct)]
            yr, hr = ms.mamba_scan(*part, A, Dv, chunk=L, h0=h_in)
            ys.append(yr)
            h_in = ends[r][1] * h_in + ends[r][0]
        # against a float64 recurrence: over 4,096 steps the float32 plain
        # version's own rounding reaches the bound (phase_lm_kernels)
        yw, hw = ms.mamba_scan_ref(*(t.double() for t in (x, dt, Bt, Ct, A,
                                                          Dv)))
        c_err = max(hold(torch, torch.cat(ys, 1).double(), yw, TOL_SCAN),
                    hold(torch, hr.double(), hw, TOL_SCAN))
        del ys, yw, ends
        exps = B * L * d * N
        s_flops = B * L * d * (6 * N + 3)
        s_bytes = 4 * (3 * B * L * d + 2 * B * L * N + d * N + d
                       + 2 * B * d * N)
        s_ops_t = max(s_flops / FP32_OPS_S, exps / SFU_EXP_S)
        s_bound = max(s_bytes / HBM_BYTES_S, s_ops_t) * 1e3
        s_by = "bytes" if s_bytes / HBM_BYTES_S >= s_ops_t else "operations"
        s_ms = device_ms(torch, lambda: ms.mamba_scan(
            *blk, A, Dv, chunk=L, h0=h0), reps=10, name="scan_kernel",
            floor=s_bound)
        s_plain = device_ms(torch, lambda: ms.mamba_scan_ref(
            *blk, A, Dv, h0=h0), reps=1, floor=s_bound)
    log(f"parallel (k) [{card}]: mamba_scan x ({B}, {L}, {d}) N={N} f32 "
        f"from a nonzero h0 (the last of {n} blocks): ok, "
        f"max_abs_err={s_err:.3e}; the {n}-block two-pass combine on the "
        f"kernel against the whole {n * L}-step scan in float64: "
        f"max_abs_err="
        f"{c_err:.3e}; device time per call (profiler): scan_kernel "
        f"{s_ms:.4f} ms, plain {s_plain:.4f} ms; bound {s_bound:.4f} ms "
        f"({s_by}: {s_bytes} bytes, {exps:.4e} exponentials)")
    del x, dt, Bt, Ct, blk, y, h
    torch.cuda.empty_cache()
    return {"flash_attention": ("q_offset", dict(
                q_offset=o, max_abs_err=f_err, ms=f_ms, plain_ms=f_plain,
                bound_ms=f_bound, bound_by=f_by, library_ms=f_lib)),
            "mamba_scan": ("h0", dict(
                max_abs_err=max(s_err, c_err), ms=s_ms, plain_ms=s_plain,
                bound_ms=s_bound, bound_by=s_by, library_ms=None))}


def parallel_seq(torch, card, ranks, g_losses) -> dict:
    """(k) from the world's ranks: the fsdp_seq prefill and decode against
    the whole model (rank 0's compare), the train steps against (g)'s
    losses, their collectives against a capture of the same step under a
    fake (2, 2) group here, and no tensor-parallel all-reduce in either;
    returns the kernel launches of the prefills (summed over the ranks)."""
    import torch.distributed as dist
    from repro_torch.core import graph
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_fake_ranks, make_mesh
    from repro_torch.parallel import transport

    from repro_torch import configs
    from repro_torch.models.blocks import layer_specs

    specs = layer_specs(configs.get_arch(LM_ARCH).replace(
        n_layers=PAR_SEQ_LAYERS))
    n_attn = sum(sp.mixer == "attn" for sp in specs)
    n_mamba = sum(sp.mixer == "mamba" for sp in specs)
    launches = {"flash_attention": 0, "mamba_scan": 0}
    for r in ranks:
        k = r["seq_serve"]
        for name in launches:
            launches[name] += k["launches"][name]
        # rank 0 scans its block once; the others again from the carry
        assert k["launches"]["flash_attention"] == n_attn, k["launches"]
        assert k["launches"]["mamba_scan"] == (n_mamba if r["rank"] == 0
                                               else 2 * n_mamba), \
            k["launches"]
        assert not any(c.startswith("all_reduce")
                       for c in k["prefill_collectives"]), k
        log(f"parallel (k) [{card}] rank {r['rank']}: fsdp_seq jamba x "
            f"{PAR_SEQ_LAYERS} on {PAR_SEQ_MESH}, positions {k['block']} of "
            f"{PAR_SEQ_PROMPT[1]}, {k['params'] / 1e9:.3f} B parameters "
            f"a rank ({k['param_bytes'] / 1e9:.3f} GB) of "
            f"{k['whole_params'] / 1e9:.3f} B, built in {k['build_s']:.2f} "
            f"s; prefill into a {PAR_SEQ_CACHE} cache {k['prefill_ms']:.1f} "
            f"ms, {PAR_SEQ_DECODE} decode step(s) {k['decode_ms']:.1f} ms "
            f"a step; peak {k['peak_bytes'] / 1e9:.3f} GB; launches "
            f"{k['launches']} (kernel shapes {k['shapes']}); holds: flash "
            f"{k['err_flash']:.3e} (rel norm {k['rel_flash']:.3e}), scan "
            f"{k['err_scan']:.3e}; prefill collectives (calls, bytes put "
            f"in) {k['prefill_collectives']}; a decode step's "
            f"{k['decode_collectives']}")
    c0 = ranks[0]["seq_serve"]
    assert c0["tp_f32"] <= RATIO_PAR_TP_F32 * c0["whole_f32"] \
        + RTOL_PAR_F32, (c0["tp_f32"], c0["whole_f32"])
    log(f"parallel (k): every step's logits ({1 + PAR_SEQ_DECODE}), the "
        f"whole model fed the same tokens and the ranks' routing "
        f"({c0['rerouted']} token-layers rerouted; free routing: prefill "
        f"rel {c0['free_rel']:.3e}): {c0['same_rel']:.3e}; against the "
        f"float32 model: fsdp_seq {c0['tp_f32']:.3e}, the whole bf16 model "
        f"{c0['whole_f32']:.3e} (bound: within {RATIO_PAR_TP_F32} x + "
        f"{RTOL_PAR_F32}); greedy tokens that agree {c0['agree']} of "
        f"{c0['n_tokens']}; the whole model's prefill "
        f"{c0['whole_prefill_ms']:.2f} ms, decode step "
        f"{c0['whole_decode_ms']:.2f} ms")

    for r in ranks:
        h = r["seq_train"]
        assert h["meta"]["fsdp"] and h["meta"]["n_micro"] == 1, h["meta"]
        assert h["launches"] == h["launches_before"], h
        rel = max(abs(a - b) / abs(b) for a, b in zip(h["losses"], g_losses))
        assert rel <= RTOL_PAR_TP_TRAIN, (h["losses"], g_losses)
        n_ar = h["executed"].get("all_reduce", [0, 0])[0]
        assert n_ar < PAR_TRAIN_LAYERS, h["executed"]
        log(f"parallel (k) [{card}] rank {r['rank']}: build_step "
            f"{h['meta']} layout fsdp_seq on {PAR_FSDP_MESH}, "
            f"{h['params'] / 1e9:.3f} B parameters a rank "
            f"({h['param_bytes']:,} bytes), moments {h['moment_bytes']:,} "
            f"bytes, built in {h['build_s']:.2f} s; losses "
            f"{[round(x, 6) for x in h['losses']]}, max rel to (g)'s "
            f"{rel:.3e} (bound {RTOL_PAR_TP_TRAIN}); step "
            f"{statistics.median(h['step_s'][1:]):.4f} s (median of steps "
            f"2-{PAR_TRAIN_STEPS}; first {h['step_s'][0]:.4f} s); peak "
            f"{h['peak_bytes'] / 1e9:.3f} GB; all-reduces in step 1: "
            f"{n_ar} ({PAR_TRAIN_LAYERS} layers: none a layer); collectives "
            f"of step 1 by route {h['routes']}")
    cfg, shape, opt = _fsdp_train_cfg()
    counts = _kernel_counts()
    t0 = time.perf_counter()
    init_fake_ranks(PAR_RANKS)
    try:
        mesh = make_mesh(PAR_FSDP_MESH, ("data", "model"), "cpu")
        step, args, _ = dryrun.build_step(cfg, shape, mesh, opt_cfg=opt,
                                          device="cpu", abstract=True,
                                          layout="fsdp_seq")
        captured = graph.capture(step, *args, fold=True)
        want = transport.as_counted(captured.collectives())
    finally:
        dist.destroy_process_group()
    assert _kernel_counts() == counts
    got = {k: tuple(v) for k, v in ranks[0]["seq_train"]["executed"]
           .items()}
    assert got == want, (got, want)
    log(f"parallel (k): rank 0's collectives of step 1 (calls, bytes put "
        f"in) {got}, equal to the fsdp_seq step's capture under a fake "
        f"{PAR_FSDP_MESH} group ({sum(captured.ops.values()):,} ops, "
        f"{time.perf_counter() - t0:.1f} s on the host)")
    return launches


def rank_seq_serve(torch, dist, transport, dev, rank):
    """(k) (a)'s jamba cut to PAR_SEQ_LAYERS layers, both kernels on,
    ``layout="fsdp_seq"`` on (data 1, model 4): one PAR_SEQ_PROMPT row (1,024 positions a rank) prefilled
    into a PAR_SEQ_CACHE cache, every flash and scan launch held against
    its plain version as it happens, then PAR_SEQ_DECODE greedy decode
    steps; the launches, collectives, times and peak.  Rank 0 then builds
    the whole model alone and compares every step's logits under (f)'s
    rule (the ranks' routing replayed, bf16 and float32)."""
    import types
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, make_model
    from repro_torch.models import mamba as mamba_mod

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_arch(LM_ARCH).replace(n_layers=PAR_SEQ_LAYERS)
    mesh = make_mesh(PAR_SEQ_MESH, ("data", "model"), "cuda")
    t0 = time.perf_counter()
    model = make_model(cfg, use_kernel=True, moe_impl="scatter", device=dev,
                       generator=torch.Generator(device=dev)
                       .manual_seed(LM_SEED), mesh=mesh, layout="fsdp_seq")
    torch.cuda.synchronize()
    info = {"build_s": time.perf_counter() - t0,
            "params": model.param_count(),
            "whole_params": model.whole_param_count(),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 2)
    prompt = torch.randint(0, cfg.vocab_size, PAR_SEQ_PROMPT, generator=gen,
                           device=dev, dtype=torch.int32)
    n = PAR_SEQ_PROMPT[1] // PAR_SEQ_MESH[1]
    info["block"] = [rank * n, (rank + 1) * n]
    hf = _Holding(torch, fa.flash_attention, _hold_flash)
    hs = _Holding(torch, ms.mamba_scan, _hold_scan)
    saved = layers.fa_ops, mamba_mod.ms_ops
    layers.fa_ops = types.SimpleNamespace(flash_attention=hf)
    mamba_mod.ms_ops = types.SimpleNamespace(mamba_scan=hs)
    counters = {"flash_attention": fa.flash_attention,
                "mamba_scan": ms.mamba_scan}
    try:
        with torch.inference_mode(), _Routes(torch) as routes:
            for c in counters.values():
                c.launches = 0
            before = _collectives(transport)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            logits, caches = model.prefill({"tokens": prompt}, PAR_SEQ_CACHE)
            torch.cuda.synchronize()
            info["prefill_ms"] = (time.perf_counter() - t0) * 1e3
            info["launches"] = {k: c.launches for k, c in counters.items()}
            info["prefill_collectives"] = _collectives(transport, before)
            n_prefill = len(routes.seen)
            tok = logits.argmax(-1)
            tokens, outs, steps = [tok.cpu()], [logits.float().cpu()], []
            before = _collectives(transport)
            for i in range(PAR_SEQ_DECODE):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = model.decode_step(
                    caches, {"tokens": tok}, PAR_SEQ_PROMPT[1] + i)
                tok = logits.argmax(-1)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0) * 1e3)
                tokens.append(tok.cpu())
                outs.append(logits.float().cpu())
            coll = _collectives(transport, before)
            # the prompt's routing as one list, in position order
            group = mesh.get_group("model")
            seen = [transport.all_gather(x.to(dev), group).flatten(0, 1)
                    .cpu() for x in routes.seen[:n_prefill]] \
                + routes.seen[n_prefill:]
    finally:
        layers.fa_ops, mamba_mod.ms_ops = saved
    info.update(decode_ms=statistics.median(steps),
                decode_collectives={k: [v[0] / PAR_SEQ_DECODE,
                                        v[1] / PAR_SEQ_DECODE]
                                    for k, v in coll.items()},
                peak_bytes=torch.cuda.max_memory_allocated(),
                err_flash=hf.err, rel_flash=hf.rel, err_scan=hs.err,
                shapes={"flash q, k": hf.shapes, "scan x, dt": hs.shapes})
    served = {"prompt": prompt.cpu(), "tokens": tokens, "logits": outs,
              "routes": seen}
    del model, logits, caches
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        info.update(_seq_whole_compare(torch, dev, cfg, served))
    dist.barrier()
    return info


def rank_tp_cache(torch, dist, transport, dev, rank):
    """(l) the reference's decode caches under ``"tp"``: for each of
    PAR_CACHE_RUNS, qwen2.5-3b (bf16, flash on) on that mesh, a prefill of
    the prompt into a PAR_CACHE_LEN cache (every flash call held against
    its plain version as it happens; then once more, timed) and
    PAR_CACHE_DECODE greedy decode steps: the rank's cache block and its bytes beside those of the layout
    it replaces (the kv heads its query heads read over the whole length),
    the times, the collectives by route, the launches.  Rank 0 then holds
    every run against the whole model (:func:`_cache_whole_compare`)."""
    import types
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, make_model

    cfg = configs.get_arch(PAR_CACHE_ARCH)
    runs, served = [], []
    for mesh_shape, prompt_shape, global_batch in PAR_CACHE_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        mesh = make_mesh(mesh_shape, ("data", "model"), "cuda")
        model = make_model(cfg, use_kernel=True, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(LM_SEED), mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(LM_SEED + 3)
        prompt = torch.randint(0, cfg.vocab_size, prompt_shape,
                               generator=gen, device=dev, dtype=torch.int32)
        rows = prompt_shape[0]
        block = model.cache_block(rows, PAR_CACHE_LEN, global_batch)
        hf = _Holding(torch, fa.flash_attention, _hold_flash)
        saved = layers.fa_ops
        layers.fa_ops = types.SimpleNamespace(flash_attention=hf)
        info = {"mesh": list(mesh_shape), "prompt": list(prompt_shape),
                "block": {"rows": block.rows, "heads": list(block.heads),
                          "lo": block.lo, "length": block.length,
                          "axes": list(block.axes)}}
        try:
            with torch.inference_mode():
                fa.flash_attention.launches = 0
                before = _collectives(transport)
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                logits, caches = model.prefill({"tokens": prompt},
                                               PAR_CACHE_LEN,
                                               global_batch=global_batch)
                torch.cuda.synchronize()
                info["prefill_first_ms"] = (time.perf_counter() - t0) * 1e3
                info["launches"] = fa.flash_attention.launches
                info["prefill_collectives"] = _collectives(transport, before)
        finally:
            layers.fa_ops = saved
        with torch.inference_mode():            # again, the kernels warm
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            model.prefill({"tokens": prompt}, PAR_CACHE_LEN,
                          global_batch=global_batch)
            torch.cuda.synchronize()
            info["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        attn = [c for c in caches if isinstance(c, dict)]
        info["cache_bytes"] = sum(t.numel() * t.element_size()
                                  for c in attn for t in c.values())
        heads = layers.attn_heads(cfg, model.tp)
        info["replaced_bytes"] = len(attn) * 2 * rows * PAR_CACHE_LEN \
            * len(heads.kv) * cfg.resolved_head_dim * attn[0]["k"] \
            .element_size()
        with torch.inference_mode():
            tok = logits.argmax(-1)
            tokens, outs, steps = [tok.cpu()], [logits.float().cpu()], []
            before = _collectives(transport)
            for i in range(PAR_CACHE_DECODE):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = model.decode_step(
                    caches, {"tokens": tok}, prompt_shape[1] + i,
                    max_len=PAR_CACHE_LEN, global_batch=global_batch)
                tok = logits.argmax(-1)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0) * 1e3)
                tokens.append(tok.cpu())
                outs.append(logits.float().cpu())
            coll = _collectives(transport, before)
        info.update(decode_ms=statistics.median(steps),
                    decode_collectives={k: [v[0] / PAR_CACHE_DECODE,
                                            v[1] / PAR_CACHE_DECODE]
                                        for k, v in coll.items()},
                    peak_bytes=torch.cuda.max_memory_allocated(),
                    err_flash=hf.err, rel_flash=hf.rel,
                    flash_shapes=hf.shapes)
        runs.append(info)
        served.append({"prompt": prompt.cpu(), "tokens": tokens,
                       "logits": outs, "routes": []})
        del model, logits, caches, attn
        dist.barrier()
    torch.cuda.empty_cache()
    out = {"runs": runs}
    if rank == 0:
        out["whole"] = _cache_whole_compare(torch, dev, cfg, served)
    dist.barrier()
    return out


def _cache_whole_compare(torch, dev, cfg, served) -> list:
    """Rank 0, alone on the card: each (l) run's prompt and tokens through
    the whole model, in bf16 and with its weights cast to float32 (the rule
    of (f)).  At most PAR_CACHE_TIES greedy tokens a run may differ from
    the whole bf16 model's, each a near tie: where the float32 model sides
    with the whole bf16 model, its lead of the one token over the other
    is within the whole bf16 model's own largest distance from float32 on
    that row (a bound the TP run's own errors do not set)."""
    from repro_torch.models import make_model
    whole = make_model(cfg, use_kernel=True, device=dev,
                       generator=torch.Generator(device=dev)
                       .manual_seed(LM_SEED))
    w16 = [_whole_serve(torch, whole, dev, s, PAR_CACHE_LEN,
                        PAR_CACHE_DECODE) for s in served]
    whole.float()                        # the same weights, cast up
    whole.cfg = whole.cfg.replace(dtype="float32")
    w32 = [_whole_serve(torch, whole, dev, s, PAR_CACHE_LEN,
                        PAR_CACHE_DECODE) for s in served]
    del whole
    torch.cuda.empty_cache()
    out = []
    for s, a16, a32 in zip(served, w16, w32):
        agree, ties = 0, []
        for tp, x16, x32, tok in zip(s["logits"], a16["logits"],
                                     a32["logits"], s["tokens"]):
            want = x16.argmax(-1)
            agree += int((want == tok).sum())
            for r in (want != tok).reshape(-1).nonzero().reshape(-1):
                row32 = x32.reshape(-1, x32.shape[-1])[r]
                gap = float(row32[want.reshape(-1)[r]]
                            - row32[tok.reshape(-1)[r]])
                noise = float((x16.reshape(-1, x16.shape[-1])[r]
                               - row32).abs().max())
                assert gap <= noise, (gap, noise)
                ties.append((gap, noise))
        assert len(ties) <= PAR_CACHE_TIES, ties
        got = torch.cat([x.flatten() for x in s["logits"]])
        b16 = torch.cat([x.flatten() for x in a16["logits"]])
        b32 = torch.cat([x.flatten() for x in a32["logits"]])
        out.append({"same_rel": _rel(torch, got, b16),
                    "tp_f32": _rel(torch, got, b32),
                    "whole_f32": _rel(torch, b16, b32), "agree": agree,
                    "ties": ties,
                    "n_tokens": sum(t.numel() for t in s["tokens"]),
                    "whole_prefill_ms": a16["prefill_ms"],
                    "whole_decode_ms": a16["decode_ms"]})
    return out


def parallel_tp_cache(card, ranks) -> int:
    """(l) from the world's ranks: each run's cache block equals the
    reference's (bytes a rank, against the layout it replaces), its flash
    launches (one an attention layer a prefill), its collectives, and rank
    0's compare with the whole model under (f)'s rule; returns the flash
    launches (summed over the ranks and runs)."""
    import torch
    from repro_torch import configs
    cfg = configs.get_arch(PAR_CACHE_ARCH)
    hd, n = cfg.resolved_head_dim, cfg.n_layers
    size = getattr(torch, cfg.dtype).itemsize
    launches = 0
    for r in ranks:
        for (mesh_shape, prompt_shape, _), k in zip(PAR_CACHE_RUNS,
                                                     r["tp_cache"]["runs"]):
            R = mesh_shape[1]
            split = "model" if cfg.n_kv_heads % R else "data"
            count = mesh_shape[1] if split == "model" else mesh_shape[0]
            heads = cfg.n_kv_heads if split == "model" \
                else cfg.n_kv_heads // R
            want = 2 * n * prompt_shape[0] * (PAR_CACHE_LEN // count) \
                * heads * hd * size
            assert k["block"]["axes"] == [split], k["block"]
            assert k["cache_bytes"] == want, (k["cache_bytes"], want)
            assert k["launches"] == n, k["launches"]
            launches += k["launches"]
            log(f"parallel (l) [{card}] rank {r['rank']}: {PAR_CACHE_ARCH} "
                f"on {tuple(mesh_shape)}, prompt {tuple(prompt_shape)}, "
                f"cache block {k['block']}: {k['cache_bytes']:,} bytes a "
                f"rank against {k['replaced_bytes']:,} in the layout it "
                f"replaces (x{k['replaced_bytes'] / k['cache_bytes']:.2f}); "
                f"prefill {k['prefill_ms']:.1f} ms (the first "
                f"{k['prefill_first_ms']:.1f} ms), a decode step "
                f"{k['decode_ms']:.1f} ms (median of {PAR_CACHE_DECODE}); "
                f"peak {k['peak_bytes'] / 1e9:.3f} GB; flash launches "
                f"{k['launches']} (shapes {k['flash_shapes']}), held "
                f"{k['err_flash']:.3e} (rel norm {k['rel_flash']:.3e}); "
                f"prefill collectives (calls, bytes put in) "
                f"{k['prefill_collectives']}; a decode step's "
                f"{k['decode_collectives']}")
    for (mesh_shape, prompt_shape, _), c in zip(
            PAR_CACHE_RUNS, ranks[0]["tp_cache"]["whole"]):
        assert c["tp_f32"] <= RATIO_PAR_TP_F32 * c["whole_f32"] \
            + RTOL_PAR_F32, c
        log(f"parallel (l) on {tuple(mesh_shape)}: every step's logits "
            f"({1 + PAR_CACHE_DECODE}), the whole model fed the same "
            f"tokens: {c['same_rel']:.3e}; against the float32 model: TP "
            f"{c['tp_f32']:.3e}, the whole bf16 model {c['whole_f32']:.3e} "
            f"(bound: within {RATIO_PAR_TP_F32} x + {RTOL_PAR_F32}); greedy "
            f"tokens equal to the whole bf16 model's {c['agree']} of "
            f"{c['n_tokens']} (near ties, at most {PAR_CACHE_TIES}, as "
            f"(float32 lead, the whole bf16 model's largest distance): "
            f"{c['ties']}); "
            f"the whole model's prefill {c['whole_prefill_ms']:.2f} ms, "
            f"decode step {c['whole_decode_ms']:.2f} ms")
    return launches


def _seq_whole_compare(torch, dev, cfg, served) -> dict:
    """Rank 0, alone on the card: (k)'s prefill and decode on the whole
    model, the ranks' routing replayed, in bf16 and with its weights cast
    to float32 (the same rule as (f))."""
    from repro_torch.models import make_model
    whole = make_model(cfg, use_kernel=True, moe_impl="scatter", device=dev,
                       generator=torch.Generator(device=dev)
                       .manual_seed(LM_SEED))
    w16 = _whole_serve(torch, whole, dev, served, PAR_SEQ_CACHE,
                       PAR_SEQ_DECODE)
    whole.float()                        # the same weights, cast up
    whole.cfg = whole.cfg.replace(dtype="float32")
    w32 = _whole_serve(torch, whole, dev, served, PAR_SEQ_CACHE,
                       PAR_SEQ_DECODE)
    del whole
    torch.cuda.empty_cache()
    got = torch.cat([x.flatten() for x in served["logits"]])
    a = torch.cat([x.flatten() for x in w16["logits"]])
    b = torch.cat([x.flatten() for x in w32["logits"]])
    agree = sum(int((x.argmax(-1) == t).sum())
                for x, t in zip(w16["logits"], served["tokens"]))
    return {"free_rel": w16["free_rel"], "rerouted": sum(w16["rerouted"]),
            "same_rel": _rel(torch, got, a), "tp_f32": _rel(torch, got, b),
            "whole_f32": _rel(torch, a, b), "agree": agree,
            "n_tokens": sum(t.numel() for t in served["tokens"]),
            "whole_prefill_ms": w16["prefill_ms"],
            "whole_decode_ms": w16["decode_ms"]}


# ------------------------------------------------------------ rank programs
class _Holding:
    """Passes each call on to a kernel wrapper and holds its output
    against the plain version at once (so no rank keeps the calls)."""

    def __init__(self, torch, fn, plain):
        self.torch, self.fn, self.plain = torch, fn, plain
        self.err = self.rel = 0.0
        self.shapes = None

    def __call__(self, *args, **kwargs):
        self.shapes = [list(a.shape) for a in args[:2]]
        out = self.fn(*args, **kwargs)
        e, r = self.plain(self.torch, args, kwargs, out)
        self.err, self.rel = max(self.err, e), max(self.rel, r)
        return out


def _hold_flash(torch, args, kw, out):
    """The flash call against ``attention_ref`` one (batch row, kv head)
    slice at a time, so the plain scores stay small."""
    from repro_torch.kernels.flash_attention import attention_ref
    q, k, v = args[:3]
    g = q.shape[2] // k.shape[2]
    err, num, den = 0.0, 0.0, 0.0
    for b in range(q.shape[0]):
        for h in range(k.shape[2]):
            want = attention_ref(q[b:b + 1, :, h * g:(h + 1) * g],
                                 k[b:b + 1, :, h:h + 1],
                                 v[b:b + 1, :, h:h + 1],
                                 causal=kw.get("causal", True),
                                 q_offset=kw.get("q_offset", 0))
            got = out[b:b + 1, :, h * g:(h + 1) * g]
            err = max(err, hold(torch, got, want, TOL_FLASH_LM))
            num += float(((got.float() - want.float()) ** 2).sum())
            den += float((want.float() ** 2).sum())
    rel = (num / den) ** 0.5
    assert rel <= RTOL_NORM_FLASH_LM, rel
    return err, rel


def _hold_scan(torch, args, kw, out):
    from repro_torch.kernels.mamba_scan import mamba_scan_ref
    yr, hr = mamba_scan_ref(*args, h0=kw.get("h0"))
    return max(hold(torch, out[0], yr, TOL_SCAN),
               hold(torch, out[1], hr, TOL_SCAN)), 0.0


def _ep_forward(torch, dev, mesh, moe_impl, holding=True):
    """The full-width 8-layer jamba with the kernels on: the model, its
    batch, the first forward's outputs, launches and holds."""
    import types
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import sweep_bracket as sb
    from repro_torch.models import layers, make_inputs, make_model
    from repro_torch.models import mamba as mamba_mod

    cfg = configs.get_arch(LM_ARCH).replace(n_layers=LM_LAYERS)
    t0 = time.perf_counter()
    model = make_model(cfg, use_kernel=True, moe_impl=moe_impl, device=dev,
                       generator=torch.Generator(device=dev)
                       .manual_seed(LM_SEED), mesh=mesh)
    batch = make_inputs(cfg, configs.get_shape("train_4k"), seed=LM_SEED,
                        batch_override=LM_BATCH, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    hf = _Holding(torch, fa.flash_attention, _hold_flash)
    hs = _Holding(torch, ms.mamba_scan, _hold_scan)
    saved = layers.fa_ops, mamba_mod.ms_ops
    if holding:
        layers.fa_ops = types.SimpleNamespace(flash_attention=hf)
        mamba_mod.ms_ops = types.SimpleNamespace(mamba_scan=hs)
    counters = {"fused_bracket_segsum": sb.fused_bracket_segsum,
                "segment_sum": sb.segment_sum,
                "flash_attention": fa.flash_attention,
                "mamba_scan": ms.mamba_scan}
    try:
        with torch.inference_mode():
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            logits, aux = model(batch)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            launches = {k: c.launches for k, c in counters.items()}
    finally:
        layers.fa_ops, mamba_mod.ms_ops = saved
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    return model, batch, logits, aux, {
        "launches": launches, "first_ms": first_ms, "build_s": build_s,
        "err_flash": hf.err, "rel_flash": hf.rel, "err_scan": hs.err,
        "shapes": {"flash q, k": hf.shapes, "scan x, dt": hs.shapes}}


def rank_world(out_dir):
    """One rank of the 4-rank gloo world: (a), (f), (c), (d), (h), (i),
    (k), (l)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.parallel import transport

    # float32 products in full float32 for the whole run: the plain
    # versions' bounds assume it
    torch.backends.cuda.matmul.allow_tf32 = False  # repro_torch: noqa[default-dtype-leak]
    torch.backends.cudnn.allow_tf32 = False  # repro_torch: noqa[default-dtype-leak]
    dev = init_ranks("gloo", "cuda")
    rank = dist.get_rank()
    res = {"rank": rank}
    try:
        res["ep"] = rank_ep(torch, dist, transport, dev, rank)
        res["ep_f32"] = rank_ep_f32(torch, dev)
        res["sweep"] = rank_sweep(torch, np, dev, rank, out_dir)
        res["pipe"] = rank_pipe(torch, np, dev)
        res["fsdp_train"] = rank_fsdp_train(torch, dist, transport, dev)
        res["fsdp_serve"] = rank_fsdp_serve(torch, dist, dev)
        res["seq_serve"] = rank_seq_serve(torch, dist, transport, dev, rank)
        res["seq_train"] = rank_fsdp_train(torch, dist, transport, dev,
                                           layout="fsdp_seq")
        res["tp_cache"] = rank_tp_cache(torch, dist, transport, dev, rank)
        res["routes"] = {f"{op} {r}": n
                         for (op, r), n in sorted(transport.routes.items())}
    finally:
        dist.destroy_process_group()
    (pathlib.Path(out_dir) / f"world{rank}.json").write_text(json.dumps(res))
    return 0


def rank_fsdp_train(torch, dist, transport, dev, layout="tp"):
    """(h) ``launch.dryrun.build_step`` for (g)'s model, batch and
    optimizer on (data 2, model 2): the meta (FSDP must be on: 1.24 GB of
    bf16 parameters a ``model`` rank), PAR_TRAIN_STEPS steps of (g)'s
    data stream, their losses and times, the bytes a rank holds, and the
    collectives of the first step by route and in all.  (k):
    ``layout="fsdp_seq"``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import make_data

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_k = _kernel_counts()
    cfg, shape, opt_cfg = _fsdp_train_cfg()
    mesh = make_mesh(PAR_FSDP_MESH, ("data", "model"), "cuda")
    t0 = time.perf_counter()
    step, (params, opt, _), meta = dryrun.build_step(cfg, shape, mesh,
                                                     opt_cfg=opt_cfg,
                                                     device=dev,
                                                     layout=layout)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    data = make_data(cfg, shape, seed=0, device=dev)
    losses, times = [], []
    for i in range(PAR_TRAIN_STEPS):
        before = transport.snapshot()
        routes = _collectives(transport)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, data.batch(i))
        losses.append(float(m.loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            executed = transport.since(before)
            by_route = _collectives(transport, routes)
    info = {"meta": meta, "losses": losses, "step_s": times,
            "build_s": build_s, "executed": executed, "routes": by_route,
            "params": sum(p.numel() for p in step.model.parameters()),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in step.model.parameters()),
            "moment_bytes": sum(x.numel() * x.element_size()
                                for k in ("mu", "nu") for x in opt[k]),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches_before": before_k, "launches": _kernel_counts()}
    del step, params, opt, m
    torch.cuda.empty_cache()
    dist.barrier()
    return info


def rank_fsdp_serve(torch, dist, dev):
    """(i) (a)'s jamba on (data 2, model 2): the TP-only model (built on
    the mesh from the same seed, no FSDP) prefills this data rank's row of
    (f)'s prompt into a PAR_TP_CACHE cache and decodes PAR_FSDP_DECODE
    greedy steps; then ``build_step``'s FSDP prefill (its meta must say
    FSDP: 13.3 GB of bf16 parameters a ``model`` rank, above 7e9) and its
    decode step, fed the TP-only run's tokens, the caches carried from one
    to the other: every step's logits against the TP-only model's."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import make_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel import sharding, transport

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before_k = _kernel_counts()
    cfg = configs.get_arch(LM_ARCH).replace(n_layers=LM_LAYERS)
    mesh = make_mesh(PAR_FSDP_MESH, ("data", "model"), "cuda")
    data_rank = mesh.get_local_rank("data")
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompt = torch.randint(0, cfg.vocab_size, PAR_TP_PROMPT, generator=gen,
                           device=dev, dtype=torch.int32)
    mine = prompt[data_rank:data_rank + 1]
    # build_step's prefill overrides; at jamba's 32 heads the padding adds
    # none, so the TP-only model decodes with the same weights
    prefill_cfg = cfg.replace(attn_expand_kv=True, head_pad_multiple=16)
    assert prefill_cfg.padded_heads == cfg.padded_heads

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # the TP-only model: (f)'s run on this mesh, greedy
    with torch.inference_mode():
        tp = make_model(prefill_cfg, moe_impl="ep_local", device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(0), mesh=mesh)
        tp_params = tp.param_count()
        (logits, caches), tp_prefill_ms = timed(
            lambda: tp.prefill({"tokens": mine}, PAR_TP_CACHE))
        tp.cfg = cfg                          # decode as build_step's does
        want, toks, steps = [logits.float().cpu()], [logits.argmax(-1)], []
        for i in range(PAR_FSDP_DECODE):
            (logits, caches), ms_ = timed(lambda: tp.decode_step(
                caches, {"tokens": toks[-1]}, PAR_TP_PROMPT[1] + i))
            steps.append(ms_)
            want.append(logits.float().cpu())
            toks.append(logits.argmax(-1))
    tp_decode_ms = statistics.median(steps)
    del tp, logits, caches
    torch.cuda.empty_cache()
    # every step's tokens of both rows: the global decode batches
    rows = transport.all_gather(torch.cat(toks, 1),
                                sharding.axes_group(mesh, ("data",)))
    glob = [rows[:, 0, j:j + 1] for j in range(PAR_FSDP_DECODE + 1)]

    with torch.inference_mode():
        step, _, meta_p = dryrun.build_step(
            cfg, ShapeConfig("serve", "prefill", PAR_TP_CACHE,
                             PAR_TP_PROMPT[0]), mesh, device=dev)
        params = step.model.param_count()
        (logits, caches), prefill_ms = timed(
            lambda: step(None, {"tokens": prompt}))
        del step
        torch.cuda.empty_cache()
        step, _, meta_d = dryrun.build_step(
            cfg, ShapeConfig("serve", "decode", PAR_TP_CACHE,
                             PAR_TP_PROMPT[0]), mesh, device=dev)
        got, steps = [logits.float().cpu()], []
        for i in range(PAR_FSDP_DECODE):
            (logits, caches), ms_ = timed(lambda: step(
                None, caches, {"tokens": glob[i]}, PAR_TP_PROMPT[1] + i))
            steps.append(ms_)
            got.append(logits.float().cpu())
    del step, logits, caches
    torch.cuda.empty_cache()
    w, g = torch.cat([x.flatten() for x in want]), \
        torch.cat([x.flatten() for x in got])
    info = {"meta_prefill": meta_p, "meta_decode": meta_d,
            "params": params, "tp_params": tp_params,
            "prefill_ms": prefill_ms,
            "decode_ms": statistics.median(steps),
            "tp_prefill_ms": tp_prefill_ms, "tp_decode_ms": tp_decode_ms,
            "equal_steps": sum(bool(torch.equal(a, b))
                               for a, b in zip(got, want)),
            "rel": _rel(torch, g, w),
            "agree": sum(int((a.argmax(-1) == b.argmax(-1)).all())
                         for a, b in zip(got, want)),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "launches_before": before_k, "launches": _kernel_counts()}
    dist.barrier()
    return info


def _collectives(transport, before=None) -> dict:
    """``{"op route": [calls, bytes put in]}`` since ``before`` (a
    snapshot: ``_collectives(transport)``)."""
    before = before or {}
    out = {}
    for (op, r), n in sorted(transport.routes.items()):
        k = f"{op} {r}"
        calls = n - before.get(k, [0, 0])[0]
        if calls:
            out[k] = [calls, transport.volume[(op, r)]
                      - before.get(k, [0, 0])[1]]
    return out


def _tp_allreduces(cfg) -> int:
    """All-reduces of one TP + EP forward: the embedding's, one a layer for
    attention, the MLP and MoE, two a mamba layer (``x_proj``'s partial
    sums and ``out_proj``'s)."""
    from repro_torch.models.blocks import layer_specs
    return 1 + sum((s.mixer == "attn") + 2 * (s.mixer == "mamba")
                   + (s.ffn != "none") for s in layer_specs(cfg))


class _Routes:
    """Within ``with``: records each MoE routing call's top-k experts, or,
    given ``replay`` (another run's records, in call order), routes with
    those instead and counts the tokens whose own choice differed."""

    def __init__(self, torch, replay=None):
        from repro_torch.models import moe
        self.torch, self.moe, self.orig = torch, moe, moe._route
        self.replay = None if replay is None else iter(replay)
        self.seen, self.rerouted = [], []

    def __enter__(self):
        def route(p, x, cfg):
            w, i, logits = self.orig(p, x, cfg)
            if self.replay is not None:
                want = next(self.replay).to(i.device)
                self.rerouted.append(int((want != i).any(-1).sum()))
                i = want
                w = self.torch.softmax(logits.gather(-1, i), dim=-1)
            self.seen.append(i.cpu())
            return w, i, logits
        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig


def _rel(torch, a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float())
                 / torch.linalg.vector_norm(b.float()))


def rank_ep(torch, dist, transport, dev, rank):
    """(a) the TP + EP forward on (data 1, model 4), then (f) TP prefill
    and decode on the same model; rank 0 then builds the whole model alone
    and compares both, with free routing and with the TP ranks' routing,
    in bf16 and cast to float32."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe

    mesh = make_mesh(PAR_MESH, ("data", "model"), "cuda")
    torch.cuda.reset_peak_memory_stats()
    before = _collectives(transport)
    with _Routes(torch) as routes:
        model, batch, logits, aux, info = _ep_forward(torch, dev, mesh,
                                                      "ep_local")
    coll = _collectives(transport, before)
    blk = moe.expert_block(model.cfg, mesh)
    info.update(experts=[blk.start, blk.stop], fwd_collectives=coll,
                fwd_allreduces=sum(v[0] for k, v in coll.items()
                                   if k.startswith("all_reduce")),
                tp_allreduces=_tp_allreduces(model.cfg),
                params=model.param_count(),
                whole_params=model.whole_param_count(),
                param_bytes=sum(p.numel() * p.element_size()
                                for p in model.parameters()))
    times = []
    with torch.inference_mode():
        for _ in range(3):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            model(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    info["fwd_ms"] = statistics.median(times)
    info["peak_bytes"] = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        loss = float(model.loss(batch))
    info.update(loss=loss, aux=float(aux))
    served = _tp_serve(torch, dist, transport, model, dev)
    info.update(served.pop("info"))
    keep = (logits.cpu(), routes.seen, served) if rank == 0 else None
    del model, logits, served
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        info.update(_whole_compare(torch, dev, loss, aux, *keep))
    dist.barrier()
    return info


def _whole_compare(torch, dev, loss, aux, tp_logits, tp_routes, served):
    """Rank 0, alone on the card: the whole model's forward with free
    routing (loss, aux, logits) and with the TP ranks' routing, in bf16
    and with its weights cast to float32; then (f) on it likewise."""
    torch.cuda.reset_peak_memory_stats()
    whole, batch, wl, wa, _ = _ep_forward(torch, dev, None, "scatter",
                                          holding=False)
    tp = tp_logits.to(dev)
    out = {"logits_rel": _rel(torch, tp, wl)}
    del wl
    with torch.inference_mode():
        wloss = float(whole.loss(batch))
        with _Routes(torch, tp_routes) as same:
            same_logits = whole(batch)[0]
    out.update(loss_whole=wloss, aux_whole=float(wa),
               loss_rel=abs(loss - wloss) / abs(wloss),
               aux_rel=abs(float(aux) - float(wa)) / abs(float(wa)),
               rerouted=same.rerouted, routed=int(tp_routes[0].shape[0]),
               same_rel=_rel(torch, tp, same_logits),
               whole_peak_bytes=torch.cuda.max_memory_allocated())
    steps16 = _whole_serve(torch, whole, dev, served)
    whole.float()                        # the same weights, cast up
    whole.cfg = whole.cfg.replace(dtype="float32")
    with torch.inference_mode(), _Routes(torch, tp_routes):
        f32 = whole(batch)[0]
    out.update(tp_f32=_rel(torch, tp, f32),
               whole_f32=_rel(torch, same_logits, f32),
               f32_peak_bytes=torch.cuda.max_memory_allocated())
    del tp, same_logits, f32
    torch.cuda.empty_cache()
    steps32 = _whole_serve(torch, whole, dev, served)
    del whole
    torch.cuda.empty_cache()
    tp_steps = torch.cat([x.flatten() for x in served["logits"]])
    w16 = torch.cat([x.flatten() for x in steps16["logits"]])
    w32 = torch.cat([x.flatten() for x in steps32["logits"]])
    agree = sum(int((x.argmax(-1) == t).sum())
                for x, t in zip(steps16["logits"], served["tokens"]))
    out.update(f_free_rel=steps16["free_rel"],
               f_rerouted=sum(steps16["rerouted"]),
               f_same_rel=_rel(torch, tp_steps, w16),
               f_tp_f32=_rel(torch, tp_steps, w32),
               f_whole_f32=_rel(torch, w16, w32), f_agree=agree,
               f_tokens=sum(t.numel() for t in served["tokens"]),
               f_whole_prefill_ms=steps16["prefill_ms"],
               f_whole_decode_ms=steps16["decode_ms"])
    return out


def _tp_serve(torch, dist, transport, model, dev) -> dict:
    """(f) TP prefill of ``PAR_TP_PROMPT`` tokens into a ``PAR_TP_CACHE``
    cache, its kernel launches held against their plain versions, then
    ``PAR_TP_DECODE`` greedy decode steps: the prompt, the tokens and the
    logits of every step (on the host), and the times."""
    import types
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import layers
    from repro_torch.models import mamba as mamba_mod

    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompt = torch.randint(0, model.cfg.vocab_size, PAR_TP_PROMPT,
                           generator=gen, device=dev, dtype=torch.int32)
    hf = _Holding(torch, fa.flash_attention, _hold_flash)
    hs = _Holding(torch, ms.mamba_scan, _hold_scan)
    saved = layers.fa_ops, mamba_mod.ms_ops
    layers.fa_ops = types.SimpleNamespace(flash_attention=hf)
    mamba_mod.ms_ops = types.SimpleNamespace(mamba_scan=hs)
    counters = {"flash_attention": fa.flash_attention,
                "mamba_scan": ms.mamba_scan}
    try:
        with torch.inference_mode(), _Routes(torch) as routes:
            for c in counters.values():
                c.launches = 0
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            logits, caches = model.prefill({"tokens": prompt}, PAR_TP_CACHE)
            torch.cuda.synchronize()
            first = (time.perf_counter() - t0) * 1e3
            launches = {k: c.launches for k, c in counters.items()}
    finally:
        layers.fa_ops, mamba_mod.ms_ops = saved
    times = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            model.prefill({"tokens": prompt}, PAR_TP_CACHE)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        tok = logits.argmax(-1)
        tokens, outs, steps = [tok.cpu()], [logits.float().cpu()], []
        before = _collectives(transport)
        with _Routes(torch) as decode_routes:
            for i in range(PAR_TP_DECODE):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = model.decode_step(caches, {"tokens": tok},
                                                   PAR_TP_PROMPT[1] + i)
                tok = logits.argmax(-1)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0) * 1e3)
                tokens.append(tok.cpu())
                outs.append(logits.float().cpu())
        coll = _collectives(transport, before)
    return {"prompt": prompt.cpu(), "tokens": tokens, "logits": outs,
            "routes": routes.seen + decode_routes.seen,
            "info": {"prefill_first_ms": first,
                     "prefill_ms": statistics.median(times),
                     "decode_ms": statistics.median(steps),
                     "decode_collectives": {
                         k: [v[0] / PAR_TP_DECODE, v[1] / PAR_TP_DECODE]
                         for k, v in coll.items()},
                     "f_launches": launches, "f_err_flash": hf.err,
                     "f_err_scan": hs.err}}


def _whole_serve(torch, whole, dev, served, max_len=PAR_TP_CACHE,
                 n_decode=PAR_TP_DECODE) -> dict:
    """(f) (and (k)) on the whole model: its prefill of the same prompt
    into a ``max_len`` cache, then each of ``n_decode`` decode steps fed
    the ranks' token, every MoE layer routed as the ranks routed it: the
    logits of every step (on the host), the prefill's logits with free
    routing against the ranks', the tokens rerouted, and the times."""
    tokens = served["tokens"]
    prompt = {"tokens": served["prompt"].to(dev)}
    start = prompt["tokens"].shape[1]
    with torch.inference_mode():
        free_rel = _rel(torch, served["logits"][0],
                        whole.prefill(prompt, max_len)[0].cpu())
        with _Routes(torch, served["routes"]) as same:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = whole.prefill(prompt, max_len)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            outs, steps = [logits.float().cpu()], []
            for i in range(n_decode):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, caches = whole.decode_step(
                    caches, {"tokens": tokens[i].to(dev)}, start + i)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0) * 1e3)
                outs.append(logits.float().cpu())
    return {"logits": outs, "free_rel": free_rel, "rerouted": same.rerouted,
            "prefill_ms": prefill_ms, "decode_ms": statistics.median(steps)}


def rank_ep_f32(torch, dev):
    """(a) the reduced jamba (8 layers, 4 experts) in float32, tensor
    parallel with EP-local experts over 4 model ranks, against the scatter
    model on this rank: the logits' largest relative gap."""
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import make_inputs, make_model
    from repro_torch.models.config import ShapeConfig

    cfg = configs.get_arch(LM_ARCH).reduced(n_layers=8).replace(
        attn_period=8, attn_offset=3)
    mesh = make_mesh(PAR_MESH, ("data", "model"), "cuda")
    batch = make_inputs(cfg, ShapeConfig("t", "train", 64, 2), device=dev)
    out = {}
    for impl, m in (("ep_local", mesh), ("scatter", None)):
        model = make_model(cfg, moe_impl=impl, device=dev, mesh=m,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
        with torch.inference_mode():
            out[impl] = model(batch)
    (a, aa), (b, ba) = out["ep_local"], out["scatter"]
    return max(float((a - b).abs().max() / b.abs().max()),
               abs(float(aa) - float(ba)) / abs(float(ba)))


def rank_sweep(torch, np, dev, rank, out_dir):
    """(c) the streaming sweep over the ranks: launches, time, the first
    chunk's pricing held against the plain version; rank 0 writes the
    result."""
    import pickle
    import repro_torch.core as pt
    from repro_torch.core import sweep_kernel as sk
    from repro_torch.kernels import sweep_bracket as sb

    cb = pickle.loads((pathlib.Path(out_dir) / "bundle.pkl").read_bytes())
    seed = pt.adaptive_sample(pt.ModelParams.multinode(), S_STREAM, seed=1,
                              mpi_transfer=["hockney", "loggp"],
                              cxl_lat_ns=(250, 700),
                              cxl_atomic_lat_ns=(300, 800))
    plan = f"{STREAM_PLAN},devices={PAR_RANKS},device={DEVICE}"
    views = []
    fused = sk.price_grid_fused

    def recording(cb_, view):
        out = fused(cb_, view)
        if not views:
            views.append((view, {k: v.clone() for k, v in out.items()}))
        return out

    pt.price(cb, seed.subset(np.arange(PAR_WARM)), plan=plan)    # warm-up
    sk.price_grid_fused = recording
    counters = {"fused_bracket_segsum": sb.fused_bracket_segsum,
                "segment_sum": sb.segment_sum}
    try:
        for c in counters.values():
            c.launches = 0
        torch.distributed.barrier()
        t0 = time.perf_counter()
        res = pt.price(cb, seed, plan=plan)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
    finally:
        sk.price_grid_fused = fused
    view, got = views[0]
    want = sk.price_grid_torch(cb, view)
    err = max(max_abs_err(got, want, TOL["f64"]), 0.0)
    flat = [res.indices.astype(np.float64), res.speedups,
            res.result.gain_ns.ravel()]
    allf = torch.as_tensor(np.concatenate(flat), device=dev)
    from repro_torch.parallel import transport
    rows = transport.all_gather(allf, torch.distributed.group.WORLD)
    equal = bool((rows == rows[0]).all())
    if rank == 0:
        agg = res.aggregates
        np.savez(pathlib.Path(out_dir) / "sweep.npz", indices=res.indices,
                 speedups=res.speedups, gain_ns=res.result.gain_ns,
                 **{k: np.asarray(getattr(agg, k)) for k in (
                     "count", "speedup_mean", "speedup_min", "speedup_max",
                     "hist", "n_beneficial", "gain_sum")})
    return {"launches": launches, "seconds": seconds, "err_bracket": err,
            "equal": equal, "shard_rows": res.shard_rows}


def rank_pipe(torch, np, dev):
    """(d) the pipeline over the world's 4 stages and 5 compressed_psum
    steps, on the card and on the CPU (one gloo group carries both); the
    int8 payloads and scales put on the wire are recorded."""
    import torch.distributed as dist
    from repro_torch.parallel import pipeline as pl

    group = dist.group.WORLD
    stage = dist.get_rank()
    p = PAR_PIPE
    rng = np.random.default_rng(p["seed"])
    ws = (rng.normal(size=(p["L"], p["D"], p["D"])) * 0.3).astype(np.float32)
    xs = rng.normal(size=(p["M"], p["B"], p["D"])).astype(np.float32)
    g_in = rng.normal(size=(5, PAR_RANKS, 4096)).astype(np.float32)
    per = p["L"] // PAR_RANKS

    def block_fn(w_stack, x):
        for w in w_stack:
            x = torch.tanh(x @ w)
        return x

    gather = pl.transport.all_gather
    res = []
    for where in (DEVICE, "cpu"):
        w = torch.tensor(ws[stage * per:(stage + 1) * per], device=where,
                         requires_grad=True)
        out = pl.pipeline_apply(w, torch.tensor(xs, device=where), block_fn,
                                group)
        (out ** 2).sum().backward()
        sent, r, outs = [], None, []

        def recording(t, grp=None):
            sent.append(t.cpu())
            return gather(t, grp)

        pl.transport.all_gather = recording
        try:
            for x in g_in:
                o, r = pl.compressed_psum(torch.tensor(x[stage], device=where),
                                          group, r)
                outs.append(o)
        finally:
            pl.transport.all_gather = gather
        res.append((out.detach().cpu(), w.grad.cpu(),
                    torch.stack(outs).cpu(), sent))
    (o1, g1, s1, w1), (o2, g2, s2, w2) = res
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    return {"pipe_out": rel(o1, o2), "pipe_grad": rel(g1, g2),
            "psum_out": rel(s1, s2),
            "psum_payload_equal": len(w1) == len(w2) == 10 and all(
                torch.equal(a, b) for a, b in zip(w1, w2))}


def rank_probe(out_dir):
    """Which collectives gloo takes from CUDA tensors, 2 ranks on the card:
    each of ``parallel.transport.GLOO_CUDA`` and the list all-to-all (which
    the port does not use) is tried and recorded; then a point-to-point
    send / receive of a CUDA tensor, which is expected to end the process
    (the parent checks that it did not complete: the reason that route is
    staged through host memory)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.parallel import transport

    dev = init_ranks("gloo", "cuda")
    rank, n = dist.get_rank(), dist.get_world_size()
    path = pathlib.Path(out_dir) / f"probe{rank}.json"
    res = {}
    ones = lambda: torch.ones(16, device=dev)
    ops = {
        "all_reduce": lambda: dist.all_reduce(ones()),
        "all_gather": lambda: dist.all_gather([ones() for _ in range(n)],
                                              ones()),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(16 * n, device=dev), torch.ones(16 * n, device=dev)),
        "broadcast": lambda: dist.broadcast(ones(), 0),
        "reduce_scatter": lambda: dist.reduce_scatter_tensor(
            ones(), torch.ones(16 * n, device=dev)),
        "all_gather_single": lambda: transport._gather_single(
            torch.empty(16 * n, device=dev), ones()),
        "reduce_scatter_single": lambda: transport._scatter_single(
            ones(), torch.ones(16 * n, device=dev)),
        "all_to_all": lambda: dist.all_to_all([ones() for _ in range(n)],
                                              [ones() for _ in range(n)]),
    }
    for name, fn in ops.items():
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except RuntimeError as e:
            res[name] = f"refused: {e}"[:200]
        dist.barrier()
        path.write_text(json.dumps(res))
    res["send/recv"] = "started"
    path.write_text(json.dumps(res))
    t = torch.ones(16, device=dev)
    if rank == 0:
        dist.send(t, 1)
    else:
        dist.recv(t, 0)
    torch.cuda.synchronize()
    res["send/recv"] = "ok"
    path.write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def rank_nccl(out_dir):
    """(e) the EP-local forward as one NCCL rank (model axis 1): equal to
    the scatter forward bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.parallel import transport

    # float32 products in full float32 for the whole run: the plain
    # versions' bounds assume it
    torch.backends.cuda.matmul.allow_tf32 = False  # repro_torch: noqa[default-dtype-leak]
    torch.backends.cudnn.allow_tf32 = False  # repro_torch: noqa[default-dtype-leak]
    dev = init_ranks("nccl", "cuda")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        model, _, logits, aux, info = _ep_forward(torch, dev, mesh,
                                                  "ep_local")
        del model
        torch.cuda.empty_cache()
        whole, _, wl, wa, _ = _ep_forward(torch, dev, None, "scatter",
                                          holding=False)
        info.update(equal=bool(torch.equal(logits, wl)),
                    aux_equal=bool(torch.equal(aux, wa)))
        transport.all_reduce(aux.clone(), dist.group.WORLD)
        info["routes"] = {f"{op} {r}": n
                          for (op, r), n in sorted(transport.routes.items())}
    finally:
        dist.destroy_process_group()
    (pathlib.Path(out_dir) / "nccl0.json").write_text(json.dumps(info))
    return 0


# --------------------------------------------------------------------------
# 13b. analysis: the analysis tier on the card
# --------------------------------------------------------------------------

#: Bytes of sentinel before and after every output of (b)'s launches, and
#: the fill of each launch: three on one fill, one on another.
ANALYSIS_GUARD = 65536
ANALYSIS_FILLS = (0xA5, 0xA5, 0xA5, 0x5A)
#: (d): the analysis tier's CLIs on the host, each of which must exit 0.
ANALYSIS_TOOLS = (
    ("lint", ["-m", "repro_torch.lint", "src/repro_torch", "chip_smoke.py"]),
    ("kernelcheck", ["-m", "repro_torch.analysis.kernelcheck"]),
    ("dataflow", ["-m", "repro_torch.analysis.dataflow"]),
    ("ircheck", ["-m", "repro_torch.analysis.ircheck", "--format", "json"]))
ANALYSIS_TOOL_TIMEOUT_S = 300
#: (b)'s main-path shapes: the LM's attention and mixer at train_4k.
ANALYSIS_FLASH_MAIN = (2, 4096, 4096, 32, 8, 128, True)
ANALYSIS_SCAN_MAIN = (2, 4096, 8192)


def _start_tools():
    """(d): the CPU tools as processes on the host, one after another in
    a thread of this process (no card: ``CUDA_VISIBLE_DEVICES`` empty)."""
    import os
    import threading
    res = {"runs": [], "error": None}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")

    def run():
        t0 = time.perf_counter()
        try:
            for name, args in ANALYSIS_TOOLS:
                t1 = time.perf_counter()
                proc = subprocess.run([sys.executable, *args], env=env,
                                      cwd=ROOT, capture_output=True,
                                      text=True,
                                      timeout=ANALYSIS_TOOL_TIMEOUT_S)
                res["runs"].append((name, proc.returncode, proc.stdout,
                                    proc.stderr[-3000:],
                                    time.perf_counter() - t1))
        except Exception as e:                  # reported by _finish_tools
            res["error"] = repr(e)
        res["wall_s"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, res


def _finish_tools(tools) -> dict:
    """(d): wait for the CPU tools; each must exit 0.  Returns ircheck's
    JSON report by entry name."""
    thread, res = tools
    thread.join(ANALYSIS_TOOL_TIMEOUT_S * len(ANALYSIS_TOOLS))
    assert not thread.is_alive(), "analysis (d): the CPU tools did not end"
    assert res["error"] is None, res["error"]
    out = {}
    for name, rc, stdout, err, secs in res["runs"]:
        assert rc == 0, (f"analysis (d): {name} exited {rc}", stdout[-3000:],
                         err)
        summary = ((err or stdout).strip().splitlines() or ["-"])[-1]
        log(f"analysis (d): {name} on the host: exit 0 in {secs:.1f} s "
            f"({summary[:160]})")
        if name == "ircheck":
            out = {e["name"]: e for e in json.loads(stdout)["entries"]}
    log(f"analysis (d): the four CPU tools {res['wall_s']:.1f} s in their "
        "thread")
    return out


def analysis_plans(torch) -> dict:
    """(a): for every registered case, the C side's plan against
    ``ops.plan`` (the card's SM count, the bracket kernel's occupancy and
    the halo flags route's co-resident CTAs read from the card), the
    card's limits, and each instantiation's attributes.  Returns the
    attributes by (kernel, instantiation)."""
    from repro_torch.analysis import kernelcheck as kc
    from repro_torch.kernels import _plan
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.halo_exchange import halo_exchange as hx_build
    from repro_torch.kernels.halo_exchange import ops as hx_ops
    from repro_torch.kernels.mamba2_state import mamba2_state as m2s_build
    from repro_torch.kernels.mamba2_state import ops as m2s_ops
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.stencil27 import ops as s27_ops
    from repro_torch.kernels.stencil27 import stencil27 as s27_build
    from repro_torch.kernels.sweep_bracket import ops as sb_ops
    from repro_torch.kernels.sweep_bracket import sweep_bracket as sb_build
    fa_build = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    ms_build = importlib.import_module(
        "repro_torch.kernels.mamba_scan.mamba_scan")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dtypes = {"float64": torch.float64, "float32": torch.float32,
              "bfloat16": torch.bfloat16}

    def bracket(case):
        dt = dtypes[case["dtype"]]
        size = dt.itemsize
        n_pairs = 3 * (case["n_max"] + case["n_max"] % 2)
        res = n_pairs * 2 * size <= sb_ops.RESIDENT_BYTES
        lib = sb_build.build()
        args = (case["S"], case["n_seg"], n_pairs, res, size, sms)
        smem = sb_ops.plan(*args, 1).smem
        attrs = _plan.c_attrs(lib.fn("sweep_bracket_attrs", dt), int(res),
                              smem)
        p = sb_ops.plan(*args, attrs["occupancy"])
        c = _plan.c_plan(lib.fn("sweep_bracket_plan", dt), case["S"],
                         case["n_seg"], n_pairs, int(res), n=13)
        assert c[11:] == (sms, attrs["occupancy"]), (case, c, sms, attrs)
        return (p, c[:11], attrs,
                f"{case['dtype']} {'resident' if res else 'tiled'}", None)

    def segsum(case):
        dt = dtypes[case["dtype"]]
        lib = sb_build.build()
        p = sb_ops.segsum_case_plan(case)
        c = _plan.c_plan(lib.fn("segsum_plan", dt), case["rows"], case["n"],
                         case["n_seg"])
        return p, c, _plan.c_attrs(lib.fn("segsum_attrs", dt), 0, 0), \
            case["dtype"], None

    def flash(case):
        dt = dtypes[case["dtype"]]
        route = fa_ops.route(dt, case["D"])
        lib, entry = fa_build.build(route), fa_build.ENTRY[route]
        p = fa_ops.case_plan(case)
        c = _plan.c_plan(lib.fn(entry + "_plan", dt),
                         *(case[k] for k in ("B", "S", "T", "Hq", "Hkv",
                                             "D")))
        attrs = _plan.c_attrs(lib.fn(entry + "_attrs", dt), case["D"], p.smem)
        return p, c, attrs, f"{route} {case['dtype']} D={case['D']}", None

    def scan(case):
        lib = ms_build.build()
        p = ms_ops.case_plan(case)
        c = _plan.c_plan(lib.fn("mamba_scan_plan", torch.float32), case["B"],
                         case["L"], case["d"] + -case["d"] % 4, 16)
        return p, c, _plan.c_attrs(lib.fn("mamba_scan_attrs", torch.float32),
                                   0, 0), "float32", None

    def halo(case):
        dt = dtypes[case["dtype"]]
        units = hx_ops.case_units(case)
        vec = units != math.prod(case["plane"])
        route = case.get("route") or hx_ops.route_for(case["n"])
        max_ctas = hx_build.max_ctas(dt, vec)
        p = hx_ops.plan(case["n"], units, route, sms, max_ctas)
        lib = hx_build.build()
        c = _plan.c_plan(lib.fn("halo_exchange_plan", dt), case["n"], units,
                         p.grid[0] // case["n"], hx_build.ROUTES[route],
                         int(vec))
        attrs = _plan.c_attrs(lib.fn("halo_exchange_attrs", dt),
                              2 * hx_build.ROUTES[route] + int(vec), 0)
        return p, c, attrs, f"{route} {case['dtype']} " \
            f"{'16-byte' if vec else 'element'} units", max_ctas

    def stencil(case):
        dt = dtypes[case["dtype"]]
        lib = s27_build.build()
        p = s27_ops.case_plan(case)
        c = _plan.c_plan(lib.fn("stencil27_plan", dt), case["n"],
                         *case["slab"])
        return p, c, _plan.c_attrs(lib.fn("stencil27_attrs", dt), 0, 0), \
            case["dtype"], None

    def mamba2_state(case):
        lib = m2s_build.build()
        p = m2s_ops.case_plan(case)
        c = _plan.c_plan(lib.fn("mamba2_state_plan", torch.float32),
                         *(case[k] for k in ("b", "H", "P", "N")))
        return p, c, _plan.c_attrs(lib.fn("mamba2_state_attrs",
                                          torch.float32), 0, 0), \
            "float32", None

    planners = {"sweep_bracket": bracket, "segment_sum": segsum,
                "flash_attention": flash, "mamba_scan": scan,
                "halo_exchange": halo, "stencil27": stencil,
                "mamba2_state": mamba2_state}
    inst, n_cases = {}, 0
    for name in kc.known_kernels():
        for case in kc.cases(name):
            p, c, attrs, variant, co_res = planners[name](dict(case))
            assert tuple(c) == p.as_ints(), (name, case, c, p.as_ints())
            bad = [n for n, ok, _ in _plan.limits(p, co_res) if not ok]
            assert not bad, (name, case, bad)
            smem = attrs["static_smem"] + p.smem
            regs = attrs["num_regs"] * p.threads
            assert regs <= _plan.REGISTERS_PER_SM, (name, case, attrs)
            assert smem <= _plan.MAX_SMEM, (name, case, attrs, p.smem)
            assert attrs["occupancy"] > 0, (name, case, attrs, p.smem)
            n_cases += 1
            key = (p.kernel, variant)
            if key not in inst or p.smem > inst[key]["smem"]:
                inst[key] = dict(attrs, smem=p.smem, threads=p.threads)
    log(f"analysis (a): {n_cases} cases of {len(kc.known_kernels())} "
        f"kernels: the C plan equals ops.plan for every one, within the "
        f"card's limits ({sms} SMs)")
    for (kernel, variant), a in sorted(inst.items()):
        log(f"analysis (a): {kernel} [{variant}]: {a['num_regs']} registers "
            f"x {a['threads']} threads = {a['num_regs'] * a['threads']} of "
            f"{_plan.REGISTERS_PER_SM}; shared {a['static_smem']} static + "
            f"{a['smem']} dynamic B (largest plan); {a['occupancy']} CTA(s) "
            f"per SM at that plan")
    spills = {k: a["local_bytes"] for k, a in inst.items() if a["local_bytes"]}
    log("analysis (a): local memory a thread (stack frame and spills; the "
        "build report splits them): " + ("; ".join(
            f"{k} [{v}] {b} B" for (k, v), b in sorted(spills.items()))
            or "none"))
    return inst


def _guarded(torch, specs, fill):
    """Outputs of ``specs`` ((shape, dtype) each), each inside a buffer of
    :data:`ANALYSIS_GUARD` bytes before and after it, every byte
    ``fill``."""
    raws, outs = [], []
    for shape, dtype in specs:
        n = math.prod(shape) * dtype.itemsize
        raw = torch.full((n + 2 * ANALYSIS_GUARD,), fill, dtype=torch.uint8,
                         device=DEVICE)
        outs.append(raw[ANALYSIS_GUARD:ANALYSIS_GUARD + n].view(dtype)
                    .view(shape))
        raws.append(raw)
    return raws, outs


def hold_guarded(torch, label, specs, run, want, tol) -> tuple:
    """(b): ``run(outs, i)`` launches a raw kernel into ``outs``: three
    launches over one fill and one over another give the same bits (every
    element written, none read before it is written, no race between CTAs
    that shows), the guard bytes stay as filled (no write outside the
    outputs), and each output against the plain version ``want`` at
    ``tol`` (bit for bit when ``None``).  Returns max |out -
    want| and the miss of ``tol`` (``None`` when it holds), which the caller
    asserts after every case has run."""
    bits = []
    for i, fill in enumerate(ANALYSIS_FILLS):
        raws, outs = _guarded(torch, specs, fill)
        run(outs, i)
        torch.cuda.synchronize()
        for raw, o in zip(raws, outs):
            end = ANALYSIS_GUARD + o.numel() * o.element_size()
            assert bool((raw[:ANALYSIS_GUARD] == fill).all()) and \
                bool((raw[end:] == fill).all()), \
                f"analysis (b) {label}: a write outside the output"
        bits.append([o.reshape(-1).view(torch.uint8).clone() for o in outs])
    for b in bits[1:]:
        assert all(torch.equal(x, y) for x, y in zip(bits[0], b)), \
            f"analysis (b) {label}: the launches' bits differ"
    if tol is None:
        assert all(torch.equal(o, w) for o, w in zip(outs, want)), label
        return 0.0, None
    err, miss = 0.0, None
    for o, w in zip(outs, want):
        try:
            err = max(err, hold(torch, o, w, tol))
        except AssertionError as e:         # reported with every case's
            miss = f"{label}: {e}"
            err = max(err, float((o.double() - w.double()).abs().max()))
    return err, miss


def analysis_launches(torch, np):
    """(b): every kernel and route, at one small and one main-path shape,
    launched through its raw ``launch*`` into guarded outputs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import halo_exchange as hx
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import sweep_bracket as sb
    from repro_torch.kernels.halo_exchange import halo_exchange as hx_build
    from repro_torch.kernels.halo_exchange import ops as hx_ops
    from repro_torch.kernels.mamba2_state import mamba2_state_update
    from repro_torch.kernels.mamba2_state import mamba2_state as m2s_build
    from repro_torch.kernels.stencil27 import apply_27pt_ref
    from repro_torch.kernels.stencil27 import stencil27 as s27_build
    from repro_torch.kernels.sweep_bracket import ops as sb_ops
    from repro_torch.kernels.sweep_bracket import sweep_bracket as sb_build
    fa_build = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    ms_build = importlib.import_module(
        "repro_torch.kernels.mamba_scan.mamba_scan")
    dev = torch.device(DEVICE)
    f64 = torch.float64
    rows = []

    def t(a, dtype=f64):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # the bracket kernel, resident and tiled
    for S, n_seg, ns in ((16, 3, (128, 128, 128)),
                         (S_MAIN, 4, (192, 64, 96))):
        rng = np.random.default_rng(S + n_seg)
        groups = [sb.csr_group(t(rng.uniform(1.0, 500.0, n)),
                               t(rng.uniform(0.1, 3.0, n)),
                               t(np.sort(rng.integers(0, n_seg, n)),
                                 torch.int64), n_seg) for n in ns]
        d, x = t(rng.uniform(-150, 400, S)), t(rng.uniform(150, 700, S))
        ref = sb.bracket_segsum_ref(*[(g.lat, g.w, g.seg) for g in groups],
                                    d, x, n_seg)
        want = [ref[k] for k in sb_ops.BRACKET_NAMES]
        args = [(g.pairs, g.offsets, g.bounds) for g in groups]
        for resident in (True, False):
            err, miss = hold_guarded(
                torch, f"bracket S={S}", [((S, n_seg), f64)] * 4,
                lambda outs, i: sb_build.launch_bracket(
                    args, d, x, n_seg, resident, outs), want, TOL["f64"])
            rows.append((f"bracket_kernel [{'resident' if resident else 'tiled'}]"
                         f" f64 S={S} n_seg={n_seg} n={ns}", err, miss))
    # the segment sum: unsorted ids, and the main path's sorted ones
    for shape, n_seg, ordered in (((3, 70), 6, False),
                                  ((S_MAIN, 192), 4, True)):
        rng = np.random.default_rng(shape[1])
        ids = rng.integers(0, n_seg, shape[1])
        seg, offsets, perm = sb_ops._csr(t(np.sort(ids) if ordered else ids,
                                           torch.int64), n_seg)
        xs = t(rng.normal(size=shape))
        err, miss = hold_guarded(
            torch, f"segsum {shape}", [((shape[0], n_seg), f64)],
            lambda outs, i: sb_build.launch_segsum(xs, offsets, perm, n_seg,
                                                   outs[0]),
            [sb.segment_sum_ref(xs, seg, n_seg)], TOL["segsum"])
        rows.append((f"segsum_kernel f64 {shape} -> {n_seg}"
                     f"{'' if ordered else ' (unsorted)'}", err, miss))
    # the halo exchange on both routes: an odd plane, HPCG's level 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, plane, dtype in ((3, (33, 31), torch.float32),
                            (8, (256, 256), torch.float32)):
        blocks = t(np.random.default_rng(n).normal(size=(n, 2, *plane)),
                   dtype)
        lo, hi = blocks[:, 0], blocks[:, -1]
        p = lo[0].numel()
        vec = hx_ops.vector_ok(p, lo.element_size(), (lo.stride(0),
                                                  hi.stride(0)),
                           (lo.data_ptr(), hi.data_ptr()))
        units = p * lo.element_size() // 16 if vec else p
        want = hx.ring_halo_exchange_ref(lo, hi)
        for route in hx_ops.ROUTES:
            if route == "cluster" and n > hx_ops.CLUSTER_MAX:
                continue
            max_ctas = hx_build.max_ctas(dtype, vec) \
                if route == "flags" else None
            chunks = hx_ops.chunk_count(n, units, sms, max_ctas)
            flags = torch.zeros(2 * n * chunks * 16, dtype=torch.int64,
                                device=dev) if route == "flags" else None
            hold_guarded(
                torch, f"halo {route} n={n}", [((n, *plane), dtype)] * 2,
                lambda outs, i: hx_build.launch(lo, hi, outs[0], outs[1],
                                                route, vec, chunks, flags,
                                                i + 1), want, None)
            rows.append((f"halo_{route}_kernel f32 n={n} plane {plane} "
                         f"({'16-byte' if vec else 'element'} units, "
                         f"{chunks} chunks)", 0.0, None))
    # the operator: a ragged slab in float32, HPCG's level 0 in float64
    for n, slab, dtype in ((3, (19, 40, 70), torch.float32),
                           (HPCG_RANKS, (HPCG_NX_FULL,) * 3, f64)):
        gen = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((n, *slab), generator=gen, dtype=dtype, device=dev)
        below, above = torch.randn((2, n, 1, *slab[1:]), generator=gen,
                                   dtype=dtype, device=dev).unbind(0)
        hold_guarded(
            torch, f"stencil27 n={n} slab {slab}", [((n, *slab), dtype)],
            lambda outs, i: s27_build.launch(x, below, above, outs[0]),
            [apply_27pt_ref(x, below, above)], None)
        rows.append((f"{OPERATOR_KERNEL} {str(dtype)[6:]} n={n} slab {slab}",
                     0.0, None))
        del x, below, above
    torch.cuda.empty_cache()
    # the Mamba-2 state update: ragged rows in two turns, granite's cell;
    # the raw launches bit for bit against a call through the wrapper,
    # which is held to the plain version within its bounds
    for b, H, P, N, G in ((5, 6, 150, 8, 2), MAMBA2_CELL):
        gen = torch.Generator(device=dev).manual_seed(b)
        f32 = dict(dtype=torch.float32, device=dev)
        xs, Bt, Ct = torch.randn((b, H * P + 2 * G * N), generator=gen,
                                 **f32).split([H * P, G * N, G * N], dim=-1)
        ins = (torch.randn((b, H, P, N), generator=gen, **f32),
               xs.reshape(b, H, P),
               torch.rand((b, H), generator=gen, **f32).mul_(0.1),
               Bt.reshape(b, G, N), Ct.reshape(b, G, N),
               torch.randn((H,), generator=gen, **f32),
               torch.randn((H,), generator=gen, **f32))
        want = mamba2_state_update(*ins)
        hold_mamba2_state(torch, ins, *want)
        hold_guarded(
            torch, f"mamba2_state b={b} H={H} P={P} N={N}",
            [((b, H, P, N), torch.float32), ((b, H, P), torch.float32)],
            lambda outs, i: m2s_build.launch(*ins, outs[0], outs[1]),
            want[::-1], None)
        rows.append((f"{MAMBA2_STATE_KERNEL} f32 b={b} H={H} P={P} N={N} "
                     f"G={G} (against the wrapper's call, which is within "
                     f"its bounds of the plain version)", 0.0, None))
        del ins, want, xs, Bt, Ct
    torch.cuda.empty_cache()
    # flash attention on both routes: a ragged small case, the LM's shape
    for route, dtype, cases in (
            ("sm90", torch.bfloat16, ((2, 192, 320, 8, 2, 128, False),
                                      ANALYSIS_FLASH_MAIN)),
            ("simt", torch.float32, ((1, 256, 256, 4, 4, 64, True),
                                     ANALYSIS_FLASH_MAIN))):
        for B, S, T, Hq, Hkv, D, causal in cases:
            rng = np.random.default_rng(S + Hq)
            q, k, v = (t(rng.normal(size=s), dtype) for s in (
                (B, S, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D)))
            want = [fa.attention_ref(q, k, v, causal)]
            err, miss = hold_guarded(
                torch, f"flash {route} S={S}", [((B, S, Hq, D), dtype)],
                lambda outs, i: fa_build.launch(q, k, v, outs[0], causal,
                                                route), want,
                TOL_FLASH["bf16" if dtype == torch.bfloat16 else "f32"])
            del want
            rows.append((f"{fa_build.KERNELS[route]} {str(dtype)[6:]} B={B} "
                         f"S={S} T={T} Hq={Hq} Hkv={Hkv} D={D} "
                         f"causal={causal}", err, miss))
    # the scan: a small case and serve (a)'s prefill (2 x 1,024 tokens)
    # against the plain version at the JAX tests' 1e-4; the LM forward's
    # 4,096 steps against a float64 recurrence, where the float32 plain
    # version is no oracle (phase_lm_kernels): the kernel must come no
    # further from it than the plain version does
    for B, L, d in ((2, 128, 64), (2, 1024, 8192), ANALYSIS_SCAN_MAIN):
        rng = np.random.default_rng(L + d)
        ins = [t(a, torch.float32) for a in (
            rng.normal(size=(B, L, d)),
            np.abs(rng.normal(0.05, 0.02, size=(B, L, d))),
            rng.normal(size=(B, L, 16)), rng.normal(size=(B, L, 16)),
            -np.abs(rng.normal(1, 0.3, size=(d, 16))), rng.normal(size=(d,)))]
        got = []

        def run(outs, i):
            ms_build.launch(*ins, outs[0], outs[1])
            got[:] = [o.clone() for o in outs]
        err, miss = hold_guarded(
            torch, f"scan L={L} d={d}", [((B, L, d), torch.float32),
                                         ((B, d, 16), torch.float32)],
            run, ms.mamba_scan_ref(*ins), TOL_SCAN)
        label = f"scan_kernel f32 B={B} L={L} d={d} N=16"
        if (B, L, d) == ANALYSIS_SCAN_MAIN:
            plain = ms.mamba_scan_ref(*ins)
            exact = ms.mamba_scan_ref(*(x.double() for x in ins))

            def off(outs):
                return max(float((o.double() - e).abs().max())
                           for o, e in zip(outs, exact))
            dev64, plain64 = off(got), off(plain)
            label += (f" (max |out - float64 recurrence| {dev64:.3e}, the "
                      f"plain version's {plain64:.3e})")
            miss = None if dev64 <= plain64 else \
                f"{label}: further from float64 than the plain version"
            del plain, exact
        rows.append((label, err, miss))
        del ins, got
    for label, err, miss in rows:
        log(f"analysis (b): {label}: 3 launches over one fill and 1 over "
            f"another bit for bit, {ANALYSIS_GUARD} guard bytes each side "
            f"untouched, max_abs_err {err:.3e} against the plain version"
            + ("" if miss is None else f" BEYOND ITS TOLERANCE ({miss})"))
    misses = [m for _, _, m in rows if m is not None]
    assert not misses, misses
    return len(rows)


def _sync_site() -> str:
    """``path:line`` of the innermost frame under ``src/`` on the stack: the
    line whose op synchronized, named as ircheck's audit names it (the
    warning's own frame may be PyTorch's)."""
    import traceback
    src = ROOT / "src"
    for f in reversed(traceback.extract_stack()):
        path = pathlib.Path(f.filename).resolve()
        if path.is_relative_to(src):
            return f"{path.relative_to(ROOT).as_posix()}:{f.lineno}"
    return "<outside src>"


def _real_call(torch, spec) -> tuple:
    """One real call of ``spec``'s step after a warm-up one: the line of
    each synchronizing operation PyTorch's sync debug mode warns of during
    it (its own syncs: the kernels' ``ctypes`` launches are not PyTorch's),
    and the growth of ``max_memory_allocated`` over the memory in use
    before it."""
    import warnings
    syncs = []

    def note(message, *_):
        if "called a synchronizing CUDA operation" in str(message):
            syncs.append(_sync_site())
    with torch.set_grad_enabled(spec.grad):
        spec.fn(*spec.args, **spec.kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note     # called where the op returns
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = spec.fn(*spec.args, **spec.kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        growth = torch.cuda.max_memory_allocated() - base
        del out
    return syncs, growth


def _hold_syncs(label, syncs, rep) -> None:
    """Every sync warning of a real call at a line where the card's
    capture saw a host sync that the entry's allow list permits."""
    allowed = {where for _, where in rep.allowed}
    outside = sorted(set(syncs) - allowed)
    assert not outside, (f"analysis (c) {label}: sync warnings outside the "
                         f"allow list at {outside} (allowed: "
                         f"{sorted(allowed)})")


def analysis_ircheck(torch, model, cpu_reports: dict) -> dict:
    """(c): every registered entry captured on the card, its findings held
    equal to the CPU run's; one real call after a warm-up under the sync
    debug mode, each sync warning held to a line the entry's allow list
    permits; its memory growth beside the capture's peak.  Then the serve phase's model (jamba x 8 at its
    widths, float32 after serve (b)) in one 8-slot decode step."""
    from repro_torch.analysis import ircheck as irc
    base = irc.load_baseline(irc.BASELINE)
    rows = {}
    for name in irc.known_entrypoints():
        with irc.ranks(irc.min_devices(name)):
            spec = irc.build_entry(name, DEVICE, abstract=True)
            rep, cap = irc.check_entry(spec, base["entries"].get(name),
                                       base["slack"])
            cpu = cpu_reports[name]
            got = [(f.rule, f.message) for f in rep.findings]
            assert got == [(f["rule"], f["message"])
                           for f in cpu["findings"]], (name, got, cpu)
            real = irc.build_entry(name, DEVICE, abstract=False)
            syncs, growth = _real_call(torch, real)
            del real, spec
        _hold_syncs(name, syncs, rep)
        rows[name] = dict(peak=cap.peak_bytes, growth=growth,
                          syncs=len(syncs),
                          cpu_peak=cpu["metrics"]["peak_live_bytes"],
                          **rep.metrics)
        log(f"analysis (c): {name} on {DEVICE}: {rep.status}, findings as "
            f"on the CPU ({len(got)}); captured peak {cap.peak_bytes:,} B "
            f"(CPU capture {rows[name]['cpu_peak']:,} B), a real call grew "
            f"max_memory_allocated by {growth:,} B (ratio "
            f"{growth / max(cap.peak_bytes, 1):.3f}); sync warnings "
            f"{len(syncs)} {sorted(set(syncs))}, all at allowed lines (the "
            f"capture saw {rep.metrics['host_syncs']} host sync(s), "
            f"{rep.metrics['host_to_device']} tensor(s) from host data, "
            f"{len(rep.allowed)} allowed)")
    # the full-width step: serve (b) left the model in float32, so its
    # caches take the weights' type
    from torch.utils import _pytree as pytree
    wdt = next(model.parameters()).dtype
    caches = pytree.tree_map(
        lambda t: t.to(wdt) if t.is_floating_point() else t,
        model.init_caches(SERVE_SLOTS, SERVE_MAX_LEN))
    tokens = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=DEVICE)
    pos = torch.arange(SERVE_SLOTS, dtype=torch.int32, device=DEVICE) \
        * (SERVE_MAX_LEN // SERVE_SLOTS)
    spec = irc.EntrySpec(
        name=f"decode {LM_ARCH} x {LM_LAYERS}",
        fn=lambda c, t, p: model.decode_step(c, {"tokens": t}, p),
        args=(caches, tokens, pos))
    rep, cap = irc.check_entry(spec)
    assert rep.status == "ok", [str(f) for f in rep.findings]
    syncs, growth = _real_call(torch, spec)
    _hold_syncs(spec.name, syncs, rep)
    rows["full-width decode"] = dict(peak=cap.peak_bytes, growth=growth,
                                     syncs=len(syncs), **rep.metrics)
    log(f"analysis (c): {LM_ARCH} x {LM_LAYERS} decode_step at "
        f"{SERVE_SLOTS} slots, cache {SERVE_MAX_LEN} "
        f"({next(model.parameters()).dtype}): {rep.status}, "
        f"{sum(cap.ops.values())} ops; captured peak {cap.peak_bytes:,} B, "
        f"copy bytes {rep.metrics['copy_transpose_bytes']:,}; a real call "
        f"grew max_memory_allocated by {growth:,} B (ratio "
        f"{growth / max(cap.peak_bytes, 1):.3f}); sync warnings "
        f"{len(syncs)} {sorted(set(syncs))} (none allowed; the capture saw "
        f"{rep.metrics['host_syncs']} host sync(s), "
        f"{rep.metrics['host_to_device']} tensor(s) from host data)")
    del caches, spec, cap
    return rows


def phase_analysis(torch, np, model, card, tools) -> dict:
    """13b. analysis: the analysis tier on the card ((a) plans and
    attributes, (b) guarded launches, (c) ircheck's entries and the
    full-width decode step) beside its CPU tools on the host ((d), started
    with :func:`_start_tools` before phase 13, whose capture leaves the
    host's other cores free).  Returns the kernel wrappers' launches
    during the phase."""
    t0 = time.perf_counter()
    before = _kernel_counts()
    analysis_plans(torch)
    t_a = time.perf_counter()
    n_b = analysis_launches(torch, np)
    t_b = time.perf_counter()
    torch.cuda.empty_cache()
    cpu = _finish_tools(tools)
    t_d = time.perf_counter()
    rows = analysis_ircheck(torch, model, cpu)
    after = _kernel_counts()
    log(f"analysis [{card}]: phase {time.perf_counter() - t0:.1f} s ((a) "
        f"{t_a - t0:.1f} s, (b) {n_b} launch sets {t_b - t_a:.1f} s, (d) "
        f"waited {t_d - t_b:.1f} s, (c) {len(rows)} steps "
        f"{time.perf_counter() - t_d:.1f} s)")
    torch.cuda.empty_cache()
    return {k: after[k] - before[k] for k in after}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    import repro_torch.core as pt
    import repro_torch.memsim as ms
    from repro_torch.apps import hpcg, stencil
    from repro_torch.apps.hpcg import torch_impl as hp
    from repro_torch.apps.stencil import torch_impl as st
    from repro_torch.comm import grid_mesh
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import halo_exchange as hx
    from repro_torch.kernels import mamba_scan as ms_k
    from repro_torch.kernels import sweep_bracket as sb
    from repro_torch.kernels.halo_exchange import halo_exchange as hx_build
    from repro_torch.kernels.sweep_bracket import sweep_bracket as sb_build
    from repro_torch.kernels.stencil27 import apply_27pt
    from repro_torch.kernels.stencil27 import stencil27 as s27_build
    from repro_torch.kernels.mamba2_state import mamba2_state as m2s_build
    # these two packages export a wrapper of their launcher module's name
    fa_build = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    ms_build = importlib.import_module(
        "repro_torch.kernels.mamba_scan.mamba_scan")

    # float32 products in full float32 for the whole run: the plain
    # versions' bounds assume it
    torch.backends.cuda.matmul.allow_tf32 = False  # repro_torch: noqa[default-dtype-leak]
    torch.backends.cudnn.allow_tf32 = False  # repro_torch: noqa[default-dtype-leak]

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    builds = (sb_build.build, hx_build.build, lambda: fa_build.build("sm90"),
              lambda: fa_build.build("simt"), ms_build.build, s27_build.build,
              m2s_build.build)
    with ThreadPoolExecutor(len(builds)) as pool:
        libs = list(pool.map(lambda build: build(), builds))
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        + ", ".join(f"{lib.path.name} ("
                    + ("on disk" if lib.seconds is None
                       else f"{lib.seconds:.2f} s") + ")" for lib in libs))
    for lib in libs:
        if lib.report:
            log("\n".join("build: " + ln for ln in
                          lib.report.strip().splitlines() if ln.strip()))

    # 3. kernels against their plain versions
    phase_kernels(torch, np, sb)
    phase_halo_kernel(torch, np, hx)
    phase_lm_kernels(torch, np, fa, ms_k)

    # 4. pricing path
    grid, bundles, results, launches = phase_main_path(torch, np, pt, ms, sb,
                                                       stencil, hpcg)

    # 5. times of the sweep kernels and of price()
    kernels = phase_times(torch, np, pt, sb, grid, bundles, card)

    # 6. the deployment-scale sweeps
    t0 = time.perf_counter()
    by_path, _ = phase_sweeps(torch, np, pt, sb, grid, bundles, results,
                              card)
    log(f"sweeps: phase {time.perf_counter() - t0:.1f} s")
    kernels[0]["launches_by_path"] = {
        "price": launches["fused_bracket_segsum"], **by_path}
    cb_stream = bundles[f"stencil tile {STREAM_TILE}"][1]
    del bundles, results
    torch.cuda.empty_cache()

    # 7. the stencil at full size
    app_times = {"stencil": phase_stencil(torch, grid_mesh, st, card)}

    # 8. HPCG: the JAX test's case, then full size, then the halo kernel's
    #    times at its strips and the operator kernel's at its slabs
    n_op = [apply_27pt.launches]
    phase_hpcg_small(torch, grid_mesh, hp)
    n_op.append(apply_27pt.launches)
    launches["halo_exchange"], blocks, app_times["hpcg"] = phase_hpcg(
        torch, grid_mesh, hp, hx, card)
    n_op.append(apply_27pt.launches)
    kernels.append(phase_halo_times(torch, hx, blocks, card))
    del blocks
    torch.cuda.empty_cache()
    kernels.append(phase_operator_times(torch, card))
    n_op.append(apply_27pt.launches)
    kernels[-1]["launches_by_path"] = dict(zip(
        ("hpcg 4 x 16^3", "hpcg 8 x 256^3", "times"),
        (b - a for a, b in zip(n_op, n_op[1:]))))

    # 8b. the Mamba-2 decode state kernel at the granite cell's shape
    phase_mamba2_state_times(torch, card)

    # 9./10. the LM forward at full width, 11. its times
    model, batch, lm_launches, rec, errs = phase_lm(torch, fa, ms_k)
    launches.update(lm_launches)
    kernels += phase_lm_times(torch, F, fa, ms_k, model, batch, rec, errs,
                              card)
    del batch, rec
    torch.cuda.empty_cache()

    # 12. serving on the same model (its engines' steps captured for 13)
    serve_launches, serve_errs, serve_steps = phase_serve(
        torch, np, fa, ms_k, model, card, pt, grid)
    for k, err in zip(kernels[-2:], serve_errs):
        launches[k["name"]] += serve_launches[k["name"]]
        k["max_abs_err"] = max(k["max_abs_err"], err)

    # 13. the advisor on the apps' and the engines' captured steps (13b's
    #     CPU tools start beside it, on the host)
    tools = _start_tools()
    n_op = apply_27pt.launches
    kernels[0]["launches_by_path"]["advisor"] = phase_advisor(
        torch, np, pt, sb, grid_mesh, st, hp, grid, app_times, serve_steps,
        card)
    launches["fused_bracket_segsum"] = sum(
        kernels[0]["launches_by_path"].values())
    # the advisor captures HPCG's solve under fake tensors: no launch
    op_row = next(k for k in kernels if k["name"] == "stencil27")
    op_row["launches_by_path"]["advisor"] = apply_27pt.launches - n_op
    assert op_row["launches_by_path"]["advisor"] == 0, op_row
    launches["stencil27"] = sum(op_row["launches_by_path"].values())
    del grid, serve_steps
    for k in kernels:
        k["launches"] = launches[k["name"]]
    torch.cuda.empty_cache()

    # 13b. the analysis tier on the card (plans, guarded launches, ircheck,
    #      the full-width decode step) beside its CPU tools
    analysis = phase_analysis(torch, np, model, card, tools)
    for k in kernels:
        k["launches_analysis"] = analysis[k["name"]]
    del model
    torch.cuda.empty_cache()

    # 14. training on the card: no kernel on its path
    counters = {"fused_bracket_segsum": sb.fused_bracket_segsum,
                "segment_sum": sb.segment_sum,
                "halo_exchange": hx.ring_halo_exchange,
                "flash_attention": fa.flash_attention,
                "mamba_scan": ms_k.mamba_scan,
                "stencil27": apply_27pt}
    for c in counters.values():
        c.launches = 0
    phase_train(torch, np, card)
    for k in kernels:
        k["launches_train"] = counters[k["name"]].launches
        assert k["launches_train"] == 0, k

    # 14b. the examples on the card
    by_example = phase_examples(card, counters)
    for k in kernels:
        k["launches_examples"] = by_example[k["name"]]
    torch.cuda.empty_cache()

    # 15. the parallel layer over ranks sharing the card (kernels built
    #     above; the ranks load them from disk)
    par_launches, par_errs, seq_rows = phase_parallel(torch, np, pt, card,
                                                      cb_stream)
    for k in kernels:
        k["launches_parallel"] = par_launches[k["name"]]
        if k["name"] in seq_rows:
            k[seq_rows[k["name"]][0]] = seq_rows[k["name"]][1]
        k["max_abs_err"] = max(k["max_abs_err"],
                               par_errs.get(k["name"], 0.0))
    for name in ("fused_bracket_segsum", "flash_attention", "mamba_scan"):
        assert par_launches[name] > 0, (name, par_launches)

    # 16. result lines
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:          # one rank of phase 15's worlds
        sys.exit({"world": rank_world, "nccl": rank_nccl,
                  "probe": rank_probe}[sys.argv[2]](sys.argv[3]))
    sys.exit(main())
