"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Every full-width engine of phases 4 to 4f (the ten archs) and phase 4g's
traced engine also passes check_waterfall: obs.engine_waterfall(engine)
under torch.profiler launches nothing, allocates nothing and moves no
wrapper count; in each call kind its rows sum to the weight bytes
exactly, each packed table's rows are its w_blocks, idx and scales bytes
times its reads a call (an exact chunk's SSM projections: C), and the
other rows are the unembedding and the routers of the param tree; each
kind's weight bytes, its bound at 3.35 TB/s and its measured p50 are
printed, and mixtral's, jamba's and the dense variants' bytes bounds
take their weight term from it (held to the hand sum of packs and
unembedding). Phase 4g's traced run embeds one waterfall record a call
kind, which validate counts and the report renders.

Phases, each printed on its own lines (each line after the seconds since
the run started), run in the order 1, 2, 3, 4, 4b, 4g, 4h, 4c, 4d, 4e, 4f,
5, 5b, 6, 6b, 7, 8, 9; any failure raises and exits non-zero (no phase catches
its own failure; phase 4g catches the one EngineStuckError it provokes):

  1. build  — nvcc builds the six kernels (joint_sparse_matmul,
              block_sparse_matmul, fta_int8_matmul, dbmu_matmul, and the
              row-stable row_attention and row_norm) from
              src/repro_torch/kernels/csrc on first use, one nvcc each, all
              started together; ptxas reports no register spills; TF32 is
              switched off for float32 matmuls and convolutions.
  2. pack   — for one full-width tinyllama-1.1b projection of each shape,
              and one full-width mamba2-1.3b layer's in_proj (2048 x 8512:
              the last of 67 N tiles holds 64 real columns) and out_proj
              (4096 x 2048), and one full-width layer slice of each
              mixtral-8x7b and arctic-480b projection shape (attention
              and expert), of jamba-v0.1-52b's new shapes (in_proj 4096 x
              16544: 130 N tiles, the last holding 32 real columns;
              out_proj 8192 x 4096; its attention, dense MLP and expert
              shapes are mixtral's), of whisper-base's (512 x 512
              self- and cross-attention, 512 x 2048, 2048 x 512) and of
              pixtral-12b's (5120 x 4096, 5120 x 1024, 4096 x 5120,
              5120 x 14336, 14336 x 5120), and of qwen3-8b's and
              gemma-7b's new shapes (4096 x 12288, 12288 x 4096; 3072 x
              4096, 4096 x 3072, 3072 x 24576, 24576 x 3072: 192 K tiles;
              stablelm-1.6b's are tinyllama's), the joint pack made on the
              card is byte-identical to the CPU pack.
  3. kernel — each kernel against its plain PyTorch version at every
              projection shape of the path, M in {4, 256}: f32 output within
              1e-5 * max|ref|, bf16 output within one bf16 ulp of max|ref|,
              DBMU bitwise equal (x with -128 and 127 in it, and x over
              [-255, 255] with +-200 and +-255 in every row), FTA/INT8
              rows of an M=4 call bitwise equal to the same rows of an
              M=256 call. The joint kernel also at mixtral's and
              arctic's and jamba's shapes with M in {4, 8, 64, 256} and
              at whisper's with M in {4, 8, 64, 256, 6000} (6000: the
              cross-attention's k/v over 4 x 1,500 encoder rows; rows of
              M=4 bitwise equal to the same rows of the others), at
              pixtral's with M in {4, 1024} (1,024: the prefill call's
              2 x 512 positions), at qwen3's and gemma's with M in {4,
              256}, at mamba2's two shapes,
              and in f32 and bf16
              activations with its fp32 accumulators, rows of an M=4 call
              bitwise equal to the same rows of an M=256 call, and the bf16
              (value-only) payload; the block-sparse pack made on the card
              equals the CPU pack byte for byte. row_attention at the serving
              shapes (batch 4, 512-slot cache, a 64-query chunk) within
              1e-5 * max|ref| (f32) or 2^-6 * max|ref| (bf16) of its plain
              version, and at the long-context serve cell's shape (batch 16,
              2048-slot cache, 256-query chunks starting at 256 * (b mod
              6)), and row_norm at 4, 256 and 4096 rows within 1e-5 *
              max|ref| or one bf16 ulp, at tinyllama's d = 2048, at
              mamba2's gated-norm d = 4096, at whisper's d = 512 and at
              jamba's gated-norm d = 8192 (a float32 scale, as the
              model's; RMSNorm and LayerNorm with a bias); row_attention
              also non-causal at 1,500 keys, hd 64, group 1 (whisper's
              encoder, 4 x 1,500 queries, and cross-attention, 1 and 64
              queries a slot), causal at whisper's decoder self-attention
              (a 448-slot cache) and at jamba's hd 128, group 4; a query
              (row) alone bitwise equal
              to the same query (row) in the chunk. row_attention also at
              caches past its resident logits (bf16 A = 32768, f32 A =
              65536): the streaming path, within the same tolerances and
              row-stable. Its lower key bound (the sliding window: keys
              at or below qpos - window dead) in all four kernels at
              pixtral's and mixtral's head layout (32 / 8 heads of 128):
              bf16 and f32 resident at 2 x 512 causal queries over their
              own keys, window 64, and streaming at 64 queries at the end
              of 32,768 (bf16) and 65,536 (f32) keys, window 4,096; within
              the same tolerances of the plain version at the same window,
              window 0 bitwise equal to the call without one, and every
              query bitwise equal alone and in the call. row_attention
              at the dense variants' serving shapes (qwen3 hd 128, group
              4; gemma hd 256, group 1; stablelm hd 64, group 1: a decode
              call and a 64-query chunk against a 512-slot cache), and
              row_norm also at gemma's d = 3,072 and over qwen3's qk-norm
              rows of 128, every width also as gemma's (1 + w) RMSNorm,
              within the same tolerances and row-stable.
  4. serve  — tinyllama-1.1b at full width in joint mode, bf16, random
              weights from a seed, through repro_torch.launch.serve's
              engine, whose decode, prefill-chunk and reset steps are each
              one captured CUDA graph: 8 requests, batch 4, max-len 512,
              prompts 32..256, 32 generated tokens, prefill chunks of 64.
              The same trace through an engine running the same in-place
              steps eagerly gives bitwise the same greedy streams and
              first-token logits, and the recompile sentinel counts one
              signature per step in both. Every request
              completes; per device call the joint kernel launches 154
              times (22 layers x 7 projections), row_attention 22 times
              and row_norm 45 times (2 per layer and the final norm), and
              no other kernel of the port launches: in the compiled run
              as the device records them (torch.profiler, by the kernels'
              symbols, graph replays included), in the eager run as the
              wrappers count them; the compiled run's wrappers count the
              first decode and prefill-chunk calls only (the warm-ups
              before capture); the first-token logits ((1, V) rows in
              bf16) of two requests agree with the same model run through
              the plain versions; a chunked prefill equals stepwise decode
              bit for bit at model level (batch 1), and op by op through
              every layer.
              Then mamba2-1.3b the same way, at full width (48 layers,
              no depth cut), its prefill chunks in the parallel SSD form:
              compiled == eager bitwise, the sentinel one signature each
              for decode, prefill_parallel and reset, per device call 96
              joint launches (48 layers x in_proj, out_proj), 97 row_norm
              (norm1 and the gated norm per layer, the final norm) and no
              row_attention, the first-token logits of two requests
              within 5e-2 x the peak of their entries other than the
              echo of the last prompt token (the tied embedding's product
              with itself, which no layer computes) of the plain
              versions', and what the layers add to the last token's
              residual stream within 5e-2 x its own peak.
  4b. ssm   — mamba2 at model level (batch 1, a 40-token prompt in
              chunks of 16, the last one ragged): exact chunks
              (prefill_exact) bitwise equal to stepwise decode (logits,
              conv windows and states of every layer); parallel chunks'
              first-token logits and layers' output against stepwise
              decode's, in bf16 and in a float32 copy (see
              phase_ssm_exact for the tolerances), the first layer's conv
              window bitwise; an exact-mode engine (2
              requests, chunks of 8) compiled == eager bitwise.
  4m. mesh  — the mesh and sharding layer ([mesh] lines): phase 4's
              8 requests served again through ServeEngine(mesh=
              make_test_mesh()), the one-card (1, 1) mesh whose step
              shardings are reckoned at the engine's shapes and checked:
              the greedy streams bitwise phase 4's and the device launches
              of the compiled run (torch.profiler's records) equal to
              phase 4's; the count of spec leaves that name "model" or
              "data" printed; then launch.dryrun.run_cell for
              tinyllama-1.1b x {decode_32k, prefill_32k} x the (16, 16)
              pod mesh on meta tensors, device memory allocated the same
              before and after, each record's FLOPs, weight bytes,
              per-device argument GB and launch.roofline row printed
              beside the card's name and power limit.
  4g. admit — admission, SLO shedding and fault containment through the
              compiled engine, on phase 4's full-width tinyllama-1.1b
              params and tables (batch 4, max-len 512, chunks of 64; 12
              requests at t = 0, prompts of 32 or 256, 32 generated).
              FIFO, then SPF with age cap 2: streams and first-token
              logits bitwise equal, skips <= the cap, another admission
              order. SLO (deadlines 62 ticks after arrival, queue cap 8,
              two NaN-logits faults on one slot): every request done, shed
              or rejected, at least one shed from the queue, one from a
              slot and one rejection; served streams FIFO's, a slot-shed
              one a prefix; the per-request ticks and outcomes equal a
              reduced tinyllama engine's on the CPU over the same lengths.
              Chaos (FaultPlan.generate seed 0, rate 0.25, over the FIFO
              run's ticks; 2 retries, 3 replays): streams bitwise FIFO's
              (a prefix for a fault-budget shed); the faults by kind equal
              the plan's events that landed, read from the trace
              (``_fault_audit``: every NaN explained by the plan); device
              launches == obs.per_call x calls; one signature a step; its
              ticks, calls, faults by kind and replays equal the CPU
              engine's under the same plan. The
              same plan traced: the same streams and device launches, the
              trace validates, renders and converts to Chrome's format;
              the tracer's host µs a tick. FaultPlan.none(): the streams
              and launches of no plan. A NaN-logits fault on slot 0 at
              tick 10 and a corruption of the reset slot at tick 11: the
              streams, the fault and replay counts and the quarantine
              ticks of the CPU engine (whose attention reads every key, as
              the reference's does; row_attention reads the dead keys'
              non-finite values the same way). mamba2-1.3b with exact chunks
              of 8 (phase 4's params and tables, 6 requests): the seed 0
              plan and a corruption of a decoding slot's state, streams
              bitwise the fault-free run's, every corrupted state read at
              its next call. max_ticks=3: EngineStuckError with its
              outputs, slot log, summary and dumped trace.
  4h. dur   — durability and paging through the compiled engine, on phase
              4's full-width tinyllama-1.1b params, tables and trace.
              The journal and snapshots (every 16 ticks) are passive: the
              same streams, calls and device launches as without them, and
              the journal folds to the streams. Killed (EngineCrash) after
              ticks 20 and 45 and restored twice from the snapshots and
              the journal: streams bitwise the uninterrupted run's,
              replayed prefill tokens <= 16 x slots restored, one
              signature per step kind in each engine. An ample paged pool
              (128 pages of 16): streams, first-token logits and device
              launches of the contiguous run, one signature a step. A
              tight pool (64 pages): at least one preemption, streams
              bitwise; killed and restored as above: bitwise. mamba2-1.3b
              with exact chunks of 8 (phase 4g's SSM trace) killed after
              ticks 6 and 11 and restored through its conv-window and
              state leaves: bitwise.
  4c. moe   — the MoE family. Grouped packs: each reduced mixtral and
              arctic expert stack packed on the card equals the CPU's
              byte for byte, and the slice-by-slice build
              (sparse_linear.init_stacked_serving) equals the whole-stack
              build on the card. mixtral-8x7b at full width and depth (32
              layers, 8 experts, window 4096), built slice by slice (its
              90 GB of dense expert stacks never exist; the build's peak
              stays under the packs + the non-expert dense weights + one
              layer's dense expert stacks), served on phase 4's trace by
              the compiled engine, prompts stepwise (prefill mode "full":
              the ring cache cannot chunk): per decode call 896 joint, 32
              row_attention and 65 row_norm launches from the device
              records; compiled == eager bitwise on 2 short requests,
              whose first-token logits agree with the plain path (stepwise,
              batch 1) within 5e-2 x max|ref|; a profiled compiled decode
              window beside its bytes bound. The ring: reduced mixtral
              (window 32) at max-len 96, requests of 70..90 positions,
              compiled == eager bitwise and the last logits past two wraps
              against the plain path (5e-2 x max|ref|); cut in width and
              depth, since at full width a wrap takes 4,096 decode calls.
              arctic-480b at full width, cut to 2 of its 35 layers (35
              layers' packs, 187 GB, outgrow the card): 2 requests with
              chunked prefill (chunks of 8, per-position dispatch),
              compiled == eager bitwise, 782 joint launches a call,
              first-token logits against the plain path, and a chunk equal
              to stepwise decode op by op, bitwise (gate values, each
              expert projection, the dense residual MLP, the MoE output).
              The joint kernel is also checked at mixtral's and arctic's
              projection shapes in phases 2 and 3 (M in 4, 8, 64, 256).
  4d. segmented — the hybrid and enc-dec families. jamba's expert
              slices packed on the card as the slice-by-slice build packs
              them == the CPU's byte for byte. jamba-v0.1-52b at full
              width and depth (32 layers: 28 SSM, 4 attention, 16 MoE of
              16 experts, 16 dense MLP), built slice by slice (the build's
              peak under packs + non-expert dense weights + one layer's
              dense expert stacks), served on phase 4's trace by the
              compiled engine with parallel SSD chunks of 64: per call 888
              joint, 4 row_attention and 93 row_norm launches from the
              device records; compiled == eager bitwise on 2 short
              requests; exact chunks (batch 1, 40 tokens in chunks of 16)
              bitwise equal to stepwise decode op by op through every
              segment (k/v rows, conv windows, states, gate values, each
              expert projection) and in every cache leaf; in bf16 the
              kernel path's first-token logits of the 2 short requests
              within 5e-2 x max|ref| of the plain path's, with the plain
              path's top-2 choices replayed into it (each side's own
              rounding flips near-tied choices); with its own routing,
              and parallel chunks vs stepwise decode, measured in bf16 and
              held in a float32 copy of its first 8 layers, every
              segment kind (cut from 32 for the run's time; kernel vs plain
              first-token logits within 1e-3 x max|ref|; parallel chunks
              within the reference's PARALLEL_PREFILL_ATOL["float32"]
              relative bounds); a profiled decode and prefill window beside the
              decode call's bytes bound. whisper-base at full width: phase
              4's checks on its trace at max-len 448 (60 joint, 12
              row_attention and 19 row_norm launches a call; compiled ==
              eager; first-token logits within 5e-2 x max|ref| of the
              plain path; a chunk == stepwise op by op, cross-attention
              included), the encoder once over 4 x 1,500 frames (6
              row_attention and 13 row_norm launches and no joint launch
              from the device records, the engine's enc_out bitwise, its
              output within 5e-2 x max|ref| of the plain path), a
              profiled decode and prefill window, and its forward (4e).
  4e. forward — the full-sequence forward (``models.forward``,
              ``models.prefill``, ``launch.steps.build_prefill_step``).
              pixtral-12b at full width and depth (40 layers, d 5,120,
              32 / 8 heads of 128, d_ff 14,336, vocab 131,072 untied, 256
              stub patches) in joint mode, built on the card (the build's
              peak under the dense weights + the packs + one float32 draw
              of the largest projection stack and its scaled copy);
              forward(frontend_embeds=...) on make_train_batch's 2 rows of
              256 patches and 256 tokens (S = 512; the joint kernel at M =
              1,024): 280 joint, 40 row_attention and 81 row_norm launches
              from the device records, the last-position logits within
              5e-2 x max|ref| of the plain path's; its prefill step on the
              same batch, text only as the reference's (the patches are
              not passed on), bitwise forward over the tokens alone (280 /
              40 / 81 launches from the device records); row 0's tokens,
              forward's last logits within 5e-2 x max|ref| of the
              engine's stepwise decode of them; then phase 4's checks on
              its trace, text-only (compiled == eager bitwise, chunk ==
              stepwise op by op, 280 / 40 / 81 launches a call, the
              sentinel, first-token logits against the plain path).
              Reduced mixtral (window 32) in float32, forward over 2 x 96
              tokens past its window: every logit within 1e-4 x max|ref|
              of the plain path's. forward(last_only) over 2 x 256 tokens
              on the resident params and tables of tinyllama, mamba2 and
              whisper (its engine's enc_out; run at the end of 4d), with
              obs.per_call's launches, within phase 4's bounds of the
              plain path (mamba2: past the tied embedding's echo, and the
              layers' output).
  4f. dense — qwen3-8b (qk-norm), gemma-7b (hd 256, group 1, GeGLU,
              (1 + w) norms, scaled and tied 256,000-row embedding) and
              stablelm-1.6b (LayerNorm with a bias, 25 % partial RoPE) at
              full width and depth in joint mode, one at a time, each
              built on the card (the build's peak under its dense
              weights + packs + one float32 draw of the largest stack and
              its scaled copy) and freed before the next: phase 4's
              checks on its trace (per call 252 / 36 / 145, 196 / 28 / 57
              and 168 / 24 / 49 joint / row_attention / row_norm launches
              from the device records; compiled == eager bitwise; one
              signature per step kind; first-token logits against the
              plain path, gemma's within 5e-2 x the peak past the tied
              embedding's echo, its layers' output gap printed; chunk ==
              stepwise op by op and over a whole
              prompt), forward(last_only) over 64 prompt tokens within
              5e-2 x max|ref| of the engine's stepwise decode of them, and
              the decode call's bytes bound (packs + unembedding).
  5. modes  — one full-width tinyllama-1.1b decoder layer (norms, chunked
              attention, MLP) with random weights, its projections packed by
              build_kernel_tables in mode "value" (vs = 0.6) and in mode
              "bit" and served through make_matmul at 4 x 64 = 256 rows:
              7 launches of the mode's kernel per layer call (with one of
              row_attention and two of row_norm), the output within
              2^-6 * max|ref| of the same layer through the plain versions; the launches of a 4-row decode call are printed (0
              by the reference's rule: rows % 128 != 0).
  5b. compress — tinyllama-1.1b's full-width params (a seeded draw)
              through sparsify_params on the card (154 slices, 1 x 8
              block pruning at 0.6, one INT8 scale a slice, FTA), one
              slice's q, mask, scale and pad byte for byte the host's;
              pim_speedup_estimate printed; quantize_params_for_serving
              on the card, one slice's q and per-filter scale byte for
              byte the host's; the int8 "serve" step (INT8
              projections with a per-filter scale, dequantized inside
              the step) for 8 lock-step decode steps at batch 4, its
              logits bitwise the dense "serve" step's over the
              dequantized params, both steps' waterfalls printed (the
              int8 step's INT8 weights charged at bf16 size in the
              untagged dot row, as the reference's walker charges them).
  6. dbmu   — the DB-PIM compilation pipeline (block pruning at 0.6, alpha 8
              -> per-tensor INT8 -> FTA -> dyadic term packing) on the card
              for every projection shape: masks and packs byte-identical to
              the CPU's, dbmu_matmul at M=256 exactly equal to the integer
              matmul oracle; then repro_torch.quickstart on the card.
  6b. paper — the paper side ([paper] lines). model_metadata (the
              synthetic INT8 weights of core/workload_gen drawn on the
              host, block pruning and FTA on the card) of each of the five
              CIFAR-100 CNNs of configs/paper_cnns at value sparsity 0.6,
              and of VGG19 unpruned, equal to the host's field for field;
              the cost model's joint speedup and energy saving over the
              dense baseline, and Fig. 11's (no input bit skip), VGG19's
              in the bands tests/test_pim_model.py holds the reference
              to. The joint kernel at the six joint_bench_shapes(128)
              layer shapes (w and the tile mask drawn with numpy as
              benchmarks/kernel_bench.py draws them): the card's pack ==
              the host's byte for byte, one counted ops.joint_dense call a
              shape (6 launches), the kernel with bf16 and f32 x within
              phase 3's tolerances of its plain version, the stored bytes
              over the dense bf16 bytes; the six launches timed in one
              profiler window beside torch.matmul on the dense weights.
  7. profile — for the functional steps (a new cache per call), the
              engine's in-place steps run eagerly, and the compiled
              engine, wall time, device
              busy time and idle share over a window of decode calls and
              over a window of prefill-chunk calls (batch 4 x 64 tokens),
              device ops and peak device memory per window, the joint
              kernel's share of the busy time, and the kernels the device
              time goes to (torch.profiler; busy counts only from a window
              whose records hold every port launch of every call, else
              it says "not measured"); then the same for the three at the
              long-context cell's shape (batch 16,
              2048-slot cache, chunks of 256, decode from 1024 filled
              positions); and mamba2's eager and compiled engines at the
              serve phase's shape, with the share of torch's own ops (the
              SSD math) beside the joint kernel's. For each compiled
              engine, the device span of a decode call (CUDA events) and
              the host time of its input signature.
  8. times  — each kernel, its plain version and one PyTorch call computing
              the same function (the library yardstick, used nowhere in the
              port) with CUDA events after warm-up; the kernel and the
              library call also in device time from torch.profiler's
              device-side records (at these sizes the event time of a lone
              launch is mostly the caller's host time), from a window
              holding every record of every call only (else "not
              measured"; every profiled window opens and ends on a pad of
              spin kernels, left out); beside the bound: the
              larger of bytes over 3.35 TB/s and operations over the peak of
              their type (989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s
              fp32 outside the tensor cores), the H100 SXM data sheet's
              rates; and the host µs per call, the time to issue
              back-to-back calls before the device has finished them (the
              fastest of several windows). Work
              units: the joint kernel one decode step (154 launches, M=4),
              and as units of their own one call's 154 launches at M=64 (a
              64-token chunk of one slot) and at M=256 (the serve phase's
              prefill-chunk call, 4 slots x 64 tokens); block-sparse and
              FTA/INT8 one full-width layer at M=256 (7 launches); DBMU the
              four projection shapes at M=256; row_attention and row_norm
              one decode call and one prefill-chunk call (22 and 45
              launches each), and as units of their own one long-context
              prefill call (batch 16 x 256 queries against a 2048-slot
              cache; 4096 rows of norms) and row_attention's streaming path
              (one slot, 64 queries at the end of a 32768-slot cache); the
              joint kernel's mamba2 units, one decode step (96 launches,
              M=4) and one prefill call (96 launches, M=256), and
              row_norm's mamba2 gated norms (48 launches at 4 and at 256
              rows, d=4096); the joint kernel's mixtral unit, one decode
              call's 768 expert launches at M=8 (an expert's capacity at
              batch 4) with torch.matmul on the dense shapes beside it;
              jamba's decode call (888 launches: experts at M=8, the rest
              at M=4) and whisper's cross-attention k/v (12 launches at
              M=6000), each with torch.matmul on the dense shapes beside
              it; row_attention's whisper encoder call (6 launches of 4 x
              1,500 queries against 1,500 keys) with SDPA beside it; the
              forward phase's units: the joint kernel at one pixtral
              prefill call (280 launches, M = 1,024) and one pixtral decode
              step (280 launches, M = 4), each with torch.matmul on the
              dense shapes beside it; row_attention at pixtral's forward
              call (40 launches of 2 x 512 causal queries over 512 keys)
              with SDPA (is_causal) beside it, and at the windowed
              streaming case (64 queries at the end of 32,768 keys,
              window 4,096, 32 launches) with SDPA under the mask; the
              joint kernel at one gemma-7b decode step (196 launches, M =
              4) with torch.matmul on the dense shapes beside it, and
              row_attention at one gemma decode call (28 launches, batch
              4, 512-slot cache, hd 256, group 1) with SDPA beside it.
  9. train  — the training path at tinyllama-1.1b's full width ([train]
              lines, ~60 s). (a) The three backward kernels against
              autograd of their plain versions: row_norm's (RMSNorm,
              LayerNorm, (1 + w) RMSNorm at d = 2048 and 4096 over 1,024
              rows, bf16 and f32; dx within 1e-5 of its peak or one bf16
              ulp, dscale and dbias within 1e-5) and row_attention's two
              (causal self-attention at B 8 x S 128 and B 1 x S 2048, 32
              / 4 heads of 64, and a window of 128 at S 512; bf16 and f32;
              dq, dk, dv within 1e-5 of their peaks or 2^-6 in bf16), each
              bitwise equal across two launches. (b) One step at the train
              CLI's defaults (batch 8, seq 128), bf16 and a float32 copy:
              every gradient leaf of the kernel path (45 + 22 forward and
              45 + 22 + 22 backward launches) against the plain path's
              (no launch) from the same params and batch, within 1e-3
              (f32) or 1e-1 (bf16) of each leaf's peak. (c) 20 steps of
              repro_torch.launch.train: finite, falling losses; 900 / 440
              / 440 backward launches and no call of a plain version;
              step p50, tokens/s and peak memory with the card's name and
              power limit. (d) 20 steps at 2 layers straight, against 10
              steps with a checkpoint (--ckpt-dir) and a second run that
              resumes there: equal within rtol 1e-5. (e) 4 steps each of
              --int8-opt (INT8 moments on the card), --grad-compression
              and --dbpim-every 2: finite losses. (f) hybrid's three
              stages on one full-width layer's seven projections, card ==
              host byte for byte. (g) mamba2-1.3b and stablelm-1.6b at full
              width and depth, mixtral-8x7b at full width and 2 layers
              (--int8-opt): (b)'s gradient check (an MoE layer's top-k
              choices replayed from the plain path), then 4 steps of
              launch.train: finite losses, 4 x (97 / 0 / 0), (49 / 24 /
              24) and (5 / 2 / 2) backward launches, forward likewise, no
              plain version called; step p50, tokens/s, peak memory. Then
              the backward kernels' times per
              launch and per training step (45 / 22 / 22 launches),
              kernel (b) as the whole backward less kernel (a), beside
              their bounds, the plain versions and the backward of
              F.rms_norm and of F.scaled_dot_product_attention (is_causal,
              GQA: dq, dk and dv in one call).

The launch counts of the JSON record come from the main paths: phases 4,
4m, 4g, 4h, 4c, 4d, 4e and 4f for the joint, row_attention and row_norm kernels
(the device's records of the compiled serve runs, tinyllama's (phase 4g's
four counted runs and phase 4h's three among them), mamba2's,
mixtral's, arctic's, jamba's, whisper's, pixtral's, qwen3's, gemma's and
stablelm's, of whisper's encoder and of pixtral's patch forward and
prefill step, and the wrappers' counts of the eager forward calls,
added), phase 5 for block-sparse and FTA/INT8,
phase 6b's six paper-shape calls for the joint kernel too, phase 6 for
DBMU, phase 9's 20 training steps and (g)'s three 4-step runs for the
three backward kernels, each counted from zero just before the path
runs. The wall time of the run is printed before
the card's line. The line before
the last holds the kernels' JSON record, the one before it the card's
name and power limit; the last line is the device record. Exits
non-zero, printing no result, without a CUDA card or outside a checkout
of the repository.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
#: phase 5b: the seed of its tinyllama-1.1b draw, the projection slice it
#: holds to the host's compression, and the int8 "serve" step's lock-step
#: batch and decode steps
COMPRESS_SEED = 7
COMPRESS_SLICE = ("blocks/mlp/w_down", 1)
INT8_SERVE_B, INT8_SERVE_STEPS = 4, 8
#: the accounting and compression checks: each serve engine's waterfall
#: ({arch: {call kind: {"total", "rows"}}}), and the seconds each part took
WATERFALLS = {}
COST_SECONDS = {}
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
FP32_FLOPS = 67e12                 # H100 SXM fp32 peak outside tensor cores
F32_TOL = 1e-5                     # f32 outputs and fp32 accumulators
#: one full-width layer, kernel path vs plain path: bf16 projections whose
#: fp32 sums run in another order may round one bf16 ulp apart, and the
#: layer's later ops carry that on; 2^-6 of the peak is a few bf16 ulps
LAYER_REL_TOL = 2.0 ** -6
#: bf16 attention, kernel vs plain: a logit whose fp32 sum lands on the
#: other side of a bf16 rounding boundary moves by one bf16 ulp of the
#: logit, and its probability with it; 2^-6 of the peak is a few bf16 ulps
ATTN_REL_TOL = 2.0 ** -6
KERNELS = ("joint_sparse_matmul", "block_sparse_matmul", "fta_int8_matmul",
           "dbmu_matmul", "row_attention", "row_norm")
SERVE_ARGS = ["--arch", "tinyllama-1.1b", "--dbpim-mode", "joint",
              "--batch", "4", "--max-len", "512", "--requests", "8",
              "--prompt-len", "32", "256", "--gen-len", "32",
              "--prefill-chunk", "64", "--seed", "0"]
#: the SSM serve phase: mamba2-1.3b at full width, the same cell
SSM_SERVE_ARGS = ["--arch", "mamba2-1.3b"] + SERVE_ARGS[2:]
#: mamba2's exact-mode checks: a model-level prompt of 40 tokens in
#: chunks of 16 (a ragged tail of 8), and an exact-mode engine serving 2
#: requests in chunks of 8
SSM_PROMPT, SSM_MODEL_CHUNK, SSM_EXACT_CHUNK = 40, 16, 8
#: first-token logits, kernel path vs plain path: both bf16 models whose
#: projections round to bf16 after fp32 sums taken in another order, over
#: 22 layers; the gap stays a small fraction of the logit range
LOGIT_REL_TOL = 5e-2
#: the pad's kernel (``torch.cuda._sleep``), left out of every reading
PAD_SYMBOL = "spin_kernel"
#: the joint kernel's prefill work units: rows per launch (a 64-token chunk
#: of one slot; the serve phase's chunk call of 4 slots x 64 tokens)
JOINT_PREFILL_M = (64, 256)
#: symbols of the joint kernel's CUDA kernels in the profiler's records
#: (the gathered-K kernels of gather_matmul.cuh; on the serving path no
#: other kernel uses them)
JOINT_SYMBOLS = ("gathered_tc_kernel", "gathered_fp32_kernel")
#: the times phase's name of the joint kernel's prefill units
JOINT_UNIT = "joint_sparse_matmul prefill"
#: the times phase's units of mamba2's joint launches (rows per launch: a
#: decode step of 4 slots; the serve phase's chunk call, 4 slots x 64)
JOINT_SSM_UNITS = {"joint_sparse_matmul mamba2 decode": 4,
                   "joint_sparse_matmul mamba2 prefill": 256}
#: the times phase's unit of mamba2's gated norms (d = 4096)
NORM_SSM_UNIT = "row_norm mamba2 gated"
#: the long-context serve cell: batch 16, max-len 2048, chunks of 256
LONG_B, LONG_A, LONG_C = 16, 2048, 256
#: the times phase's names of row_attention's and row_norm's long-context
#: units (one prefill-chunk call of the long-context cell)
ATTN_LONG_UNIT = "row_attention long context"
NORM_LONG_UNIT = "row_norm long context"
#: the MoE serve phase: mixtral-8x7b at full width and depth, the same
#: cell (its sliding window makes the engine prefill stepwise, so the
#: chunk size is unused)
MOE_SERVE_ARGS = ["--arch", "mixtral-8x7b"] + SERVE_ARGS[2:]
#: mixtral's compiled == eager check and its first-token logits against
#: the plain path: 2 requests of 8..16 prompt tokens, 4 generated (the
#: eager engine issues 896 joint launches a call from the host)
MOE_SHORT = dict(n_requests=2, arrival_rate=0.0, prompt_len=(8, 16),
                 gen_len=(4, 4), seed=5)
#: the ring wrapping on the card: reduced mixtral (window 32) at max-len
#: 96, requests of 70..90 positions, so every ring wraps more than once
#: (full width would take over 4,096 decode calls a wrap)
RING_ARGS = ["--arch", "mixtral-8x7b", "--reduced", "--dbpim-mode", "joint",
             "--batch", "4", "--max-len", "96", "--requests", "4",
             "--prompt-len", "40", "60", "--gen-len", "30", "--seed", "0"]
#: arctic-480b at full width, cut to 2 of its 35 layers: 35 layers' packs
#: (187.4 GB) outgrow one card; 2 requests with chunked prefill
ARCTIC_LAYERS = 2
ARCTIC_ARGS = ["--arch", "arctic-480b", "--dbpim-mode", "joint", "--batch",
               "4", "--max-len", "128", "--requests", "2", "--prompt-len",
               "16", "48", "--gen-len", "8", "--prefill-chunk", "8",
               "--seed", "0"]
#: the joint kernel's rows per launch at the MoE path's shapes: a decode
#: step (4), an expert's capacity at batch 4 (8), an arctic chunk's expert
#: launch (8 positions x 8) and a prefill-chunk call (256)
MOE_KERNEL_M = (4, 8, 64, 256)
#: the times phase's unit of mixtral's expert launches (one decode call:
#: 32 layers x 3 projections x 8 experts, 8 rows each)
JOINT_MOE_UNIT = "joint_sparse_matmul mixtral experts"
#: caches past the resident logits' limit (bf16 25,600 rows at hd 64, f32
#: 57,852): row_attention's streaming path, and its times unit (one slot,
#: a 64-query chunk at the end of a 32,768-slot cache)
STREAM_A_BF16, STREAM_A_F32, STREAM_C = 32768, 65536, 64
ATTN_STREAM_UNIT = "row_attention streaming"

#: the segmented phase: jamba-v0.1-52b at full width and depth on phase
#: 4's trace (parallel SSD chunks of 64), and whisper-base at full width on
#: the same trace at its decoder context of 448
JAMBA_SERVE_ARGS = ["--arch", "jamba-v0.1-52b"] + SERVE_ARGS[2:]
WHISPER_MAX_LEN = 448
WHISPER_SERVE_ARGS = (["--arch", "whisper-base"] + SERVE_ARGS[2:6]
                      + ["--max-len", str(WHISPER_MAX_LEN)] + SERVE_ARGS[8:])
#: jamba's chunks at model level: batch 1, a 40-token prompt in chunks of
#: 16 (the last ragged)
JAMBA_PROMPT, JAMBA_CHUNK = 40, 16
#: jamba's first-token logits in float32, kernel path vs plain path: fp32
#: sums in other orders (1e-5 of a projection's peak) carried through the
#: layers (set for all 32)
JAMBA_F32_REL = 1e-3
#: the float32 copy's depth, cut for the run's time: the first 8 of 32
#: layers hold every segment kind (7 SSM, the attention layer at index 4,
#: 4 MoE and 4 dense MLP); its build takes a quarter of the full depth's
JAMBA_F32_LAYERS = 8
#: the joint kernel's rows per launch at whisper's shapes: a decode step,
#: an expert-sized launch, a chunk of one slot, a chunk call, and the
#: cross-attention's k/v over 4 slots x 1,500 encoder rows
WHISPER_KERNEL_M = (4, 8, 64, 256, 6000)
#: the times phase's units of the segmented phase
#: launches per call the segmented phase holds its runs to (obs.per_call)
JAMBA_PER_CALL = {"joint_sparse_matmul": 888, "row_attention": 4,
                  "row_norm": 93}
WHISPER_PER_CALL = {"joint_sparse_matmul": 60, "row_attention": 12,
                    "row_norm": 19}
WHISPER_ENCODER_PER_CALL = {"joint_sparse_matmul": 0, "row_attention": 6,
                            "row_norm": 13}
JOINT_JAMBA_UNIT = "joint_sparse_matmul jamba decode call"
JOINT_XATTN_UNIT = "joint_sparse_matmul whisper cross K/V"
ATTN_ENCODER_UNIT = "row_attention whisper encoder call"

#: the forward phase: pixtral-12b at full width and depth on the serve
#: phase's trace (text-only), and its prefill step on make_train_batch's
#: batch of 2 rows of 256 patches and 256 tokens (S = 512, the joint
#: kernel at M = 1,024)
PIXTRAL_SERVE_ARGS = ["--arch", "pixtral-12b"] + SERVE_ARGS[2:]
PIXTRAL_BATCH, PIXTRAL_TOKENS = 2, 256
#: launches of one pixtral prefill (forward) call: 40 layers x 7
#: projections, 40 attention layers, 2 norms a layer and the final norm
PIXTRAL_PER_CALL = {"joint_sparse_matmul": 280, "row_attention": 40,
                    "row_norm": 81}
#: the window bound in row_attention: 512 causal queries over their own
#: 512 keys with a window of 64 (resident logits), and 64 queries at the
#: end of a long sequence with mixtral's window of 4,096 (streaming)
WINDOW_S, WINDOW_RESIDENT, WINDOW_STREAM = 512, 64, 4096
#: reduced mixtral (window 32) in float32 on the card, past its window:
#: the kernel path's forward against the plain path's (fp32 sums in
#: other orders through 2 layers)
MIXTRAL_FWD_S, MIXTRAL_F32_REL = 96, 1e-4
#: tokens per row of the resident families' forward checks (a multiple
#: of mamba2's SSD chunk of 256)
FAMILY_FWD_S = 256
#: the times phase's units of the forward phase
ATTN_FWD_UNIT = "row_attention pixtral forward"
#: the joint kernel's rows per launch at pixtral's shapes: a decode step,
#: and the prefill call's 2 rows of 512 positions
PIXTRAL_KERNEL_M = (4, 1024)
ATTN_WINDOW_UNIT = "row_attention windowed streaming"
JOINT_PIXTRAL_PREFILL_UNIT = "joint_sparse_matmul pixtral prefill"
JOINT_PIXTRAL_DECODE_UNIT = "joint_sparse_matmul pixtral decode"

#: the dense variants' phase: each at full width and depth on the serve
#: phase's trace, with the launches of one step call (obs.per_call):
#: qwen3-8b (qk-norm: two more norms an attention layer), gemma-7b (hd
#: 256 with one query head per KV head, GeGLU, (1 + w) norms, a scaled
#: and tied 256,000-row embedding) and stablelm-1.6b (LayerNorm with a
#: bias, 25 % partial RoPE, hd 64 with one query head per KV head)
DENSE_PER_CALL = {
    "qwen3-8b": {"joint_sparse_matmul": 252, "row_attention": 36,
                 "row_norm": 145},
    "gemma-7b": {"joint_sparse_matmul": 196, "row_attention": 28,
                 "row_norm": 57},
    "stablelm-1.6b": {"joint_sparse_matmul": 168, "row_attention": 24,
                      "row_norm": 49}}
#: tokens of the first prompt that forward(last_only) and stepwise decode
#: take in the dense variants' forward-last check
DENSE_FWD_S = 64
#: the times phase's units of gemma-7b's decode call
JOINT_GEMMA_DECODE_UNIT = "joint_sparse_matmul gemma decode"
ATTN_GEMMA_DECODE_UNIT = "row_attention gemma decode"
#: phase 4g: admission, SLO shedding and fault containment, on the serve
#: phase's full-width tinyllama-1.1b params and tables: 12 requests all at
#: t = 0, prompts of 32 or 256 tokens (bimodal), 32 generated each
ADMIT_SPEC = dict(n_requests=12, arrival_rate=0.0, prompt_len=(32, 256),
                  gen_len=(32, 32), dist="bimodal", seed=0)
ADMIT_GEOMETRY = dict(n_slots=4, max_len=512, prefill_chunk=64)
SPF_AGE_CAP = 2
#: the SLO run: deadlines 62 ticks after arrival and a queue of 8 (the
#: last 4 requests are rejected). Requests 6 and 7 cannot make it from the
#: queue and are shed there; request 4 is admitted at tick 31 with no tick
#: to spare, and two NaN-logits faults on its slot (its decode at tick 40,
#: then its replay's chunk) cost it the tick that sheds it from its slot
SLO_SLACK, SLO_QUEUE_CAP = 62.0, 8
SLO_EVENTS = (dict(tick=40, kind="nan_logits", call="decode", slot=1),
              dict(tick=41, kind="nan_logits", call="prefill", slot=1))
#: the chaos run: FaultPlan.generate over the fault-free run's ticks
CHAOS = dict(seed=0, rate=0.25)
CHAOS_RETRIES, CHAOS_REPLAYS = 2, 3
#: a cache corruption of a slot reset the tick before: request 0 (prompt
#: 256) decodes in slot 0 at tick 10, a NaN-logits fault quarantines it,
#: and the poison of tick 11 lands on the zeroed slot
DEAD_KEY_EVENTS = (dict(tick=10, kind="nan_logits", call="decode", slot=0),
                   dict(tick=11, kind="cache_corruption", slot=0))
#: mamba2's exact-chunk chaos run: 6 requests, prompts 20-40 in chunks of
#: SSM_EXACT_CHUNK, 8 generated, 4 slots; a cache corruption of slot 1 at
#: tick 6 (decoding) joins the generated plan
SSM_CHAOS_SPEC = dict(n_requests=6, arrival_rate=0.0, prompt_len=(20, 40),
                      gen_len=(8, 8), seed=5)
SSM_CHAOS_EVENT = dict(tick=6, kind="cache_corruption", slot=1)
STUCK_TICKS = 3
#: phase 4h (durability and paging) on the serve phase's trace (73 ticks):
#: a snapshot every 16 ticks, the engine killed after ticks 20 and 45 (both
#: past the first snapshot); a tight pool of 64 pages of 16 (the serve
#: geometry holds 128), which preempts once on this trace (found with the
#: reduced CPU engine, whose schedule depends on lengths and ticks only)
DUR_SNAPSHOT_EVERY, DUR_CRASH_TICKS = 16, (20, 45)
PAGE_SIZE, TIGHT_PAGES = 16, 64
#: mamba2's exact-chunk kill-and-restore: phase 4g's SSM trace, a snapshot
#: every 4 ticks, killed after ticks 6 and 11
SSM_DUR_SNAPSHOT_EVERY, SSM_DUR_CRASH_TICKS = 4, (6, 11)


_T0 = time.monotonic()


def log(msg: str):
    """A line of the run's log, after the seconds since the run started."""
    print(f"{time.monotonic() - _T0:7.1f} {msg}", flush=True)


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _path_shapes(cfg):
    """(name, K, N) of every projection on the serving path: attention's
    (cross-attention's are the same shapes), the SSM's, then the MLP's
    (an expert's are the same shapes)."""
    d, f = cfg.d_model, cfg.d_ff
    out = []
    if cfg.family != "ssm":
        q, kv = cfg.q_dim, cfg.kv_dim
        out += [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d)]
    if cfg.family in ("ssm", "hybrid"):
        d_in, N, nh = cfg.ssm_expand * d, cfg.ssm_state, \
            cfg.ssm_expand * d // cfg.ssm_head_dim
        out += [("in_proj", d, 2 * d_in + 2 * N + nh), ("out_proj", d_in, d)]
    if cfg.family != "ssm":
        if cfg.mlp_type in ("swiglu", "geglu"):
            out.append(("w_gate", d, f))
        out += [("w_up", d, f), ("w_down", f, d)]
    return out


def _distinct(shapes):
    seen, out = set(), []
    for name, K, N in shapes:
        if (K, N) not in seen:
            seen.add((K, N))
            out.append((name, K, N))
    return out


def _tiles(K, N):
    """The tile rule of sparse_linear.build_stacked_tables (128 at full
    width, the dims rounded up to a multiple of 8 below that)."""
    return dict(bk=min(128, 8 * -(-K // 8)), bn=min(128, 8 * -(-N // 8)))


def _kernel_modules():
    """name -> the wrapper module holding the kernel's LAUNCHES count."""
    from repro_torch.kernels import (block_sparse_matmul, dbmu_sim,
                                     fta_int8_matmul, joint_sparse_matmul,
                                     row_attention, row_norm)
    return {"joint_sparse_matmul": joint_sparse_matmul,
            "block_sparse_matmul": block_sparse_matmul,
            "fta_int8_matmul": fta_int8_matmul, "dbmu_matmul": dbmu_sim,
            "row_attention": row_attention, "row_norm": row_norm}


def reset_launches():
    for mod in _kernel_modules().values():
        mod.LAUNCHES = 0


def read_launches():
    return {name: mod.LAUNCHES for name, mod in _kernel_modules().items()}


def phase_build():
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    build.build_all(KERNELS)
    for name in KERNELS:
        build.load(name)
        ptxas = build.PTXAS_LOG.get(name, "")
        regs = [ln.strip() for ln in ptxas.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                              ptxas)]
        assert not any(spills), (name, "spills", ptxas)
        log(f"[build] {name} built in {build.BUILD_SECONDS[name]:.2f} s; "
            f"ptxas: {len(regs)} instantiations, no spills, e.g. "
            f"{regs[0] if regs else 'n/a'}")
    log(f"[build] all {len(KERNELS)} kernels built and loaded in "
        f"{time.monotonic() - t0:.2f} s (one nvcc each, in parallel)")


def phase_pack(cfg, dev, have=None):
    """Full-width packs of one layer per projection shape: card vs CPU.
    Shapes already packed and checked for another model (``have``, its
    packs by (K, N)) are taken from there."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(1)
    packs = {}
    for name, K, N in _distinct(_path_shapes(cfg)):
        if have and (K, N) in have:
            packs[(K, N)] = have[(K, N)]
            log(f"[pack] {cfg.name} {name} {K}x{N}: the same shape as a "
                f"projection checked above")
            continue
        w = (torch.randn((1, K, N), generator=gen) * K ** -0.5)
        w = w.to(torch.bfloat16)
        t0 = time.monotonic()
        on_card = ops.pack_joint_sparse_stacked(
            w.to(dev), value_sparsity=cfg.dbpim_value_sparsity, **_tiles(K, N))
        torch.cuda.synchronize()
        t_card = time.monotonic() - t0
        t0 = time.monotonic()
        on_cpu = ops.pack_joint_sparse_stacked(
            w, value_sparsity=cfg.dbpim_value_sparsity, **_tiles(K, N))
        t_cpu = time.monotonic() - t0
        for field in ("w_blocks", "idx", "scales", "nblocks"):
            a, b = getattr(on_card, field).cpu(), getattr(on_cpu, field)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
        assert (on_card.k, on_card.n, on_card.k_pad) == \
            (on_cpu.k, on_cpu.n, on_cpu.k_pad)
        _, nt, maxb, bk, bn = on_card.w_blocks.shape
        log(f"[pack] {name} {K}x{N}: NT={nt} MAXB={maxb} bk={bk} bn={bn} "
            f"card pack == cpu pack byte for byte "
            f"(card {t_card:.2f} s, cpu {t_cpu:.2f} s)")
        packs[(K, N)] = ops.slice_joint_stacked(on_card, 0)
    return packs


def _joint_vs_plain(x, p, what, tag="kernel"):
    """The joint kernel on x against pack ``p``, in x's dtype and with
    fp32 accumulators out, against its plain version: the f32 output
    within 1e-5 * max|ref|, x's dtype within that or one bf16 ulp of the
    peak. Returns (the kernel's output in x's dtype, its max abs error)."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    y = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales)
    acc = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales,
                                  out_dtype=torch.float32)
    torch.cuda.synchronize()
    ref = jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx, p.scales)
    ref_acc = jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx, p.scales,
                                            torch.float32)
    peak = ref_acc.abs().max().item()
    err_acc = (acc - ref_acc).abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    tol = F32_TOL * peak if x.dtype == torch.float32 else _bf16_ulp(peak)
    M, dt = x.shape[0], str(x.dtype)[6:]
    assert err_acc <= F32_TOL * peak, (what, dt, M, err_acc)
    assert err <= tol, (what, dt, M, err, tol)
    log(f"[{tag}] {what} {dt} M={M}: max|d|={err:.3e} (tol {tol:.3e}), acc "
        f"max|d|={err_acc:.3e} (tol {F32_TOL * peak:.3e})")
    return y, err


def phase_kernel(cfg, packs, dev, ms=(4, 256), have=()):
    """Kernel vs plain at every path shape (but those of ``have``, checked
    for another model), at each row count of ``ms``; returns the max abs
    error of the bf16 outputs (the serving dtype)."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    gen = torch.Generator().manual_seed(2)
    worst_bf16 = 0.0
    for name, K, N in _distinct(_path_shapes(cfg)):
        if (K, N) in have:
            continue
        p = packs[(K, N)]
        for dt in (torch.bfloat16, torch.float32):
            x256 = torch.randn((max(ms), K), generator=gen).to(dt).to(dev)
            for M in ms:
                y, err = _joint_vs_plain(x256[:M].contiguous(), p,
                                         f"{name} {K}x{N}")
                if dt == torch.bfloat16:
                    worst_bf16 = max(worst_bf16, err)
                if M == ms[0]:
                    head = y
                else:
                    assert torch.equal(head, y[:ms[0]]), (name, dt, "rows")
            log(f"[kernel] {name} {str(dt)[6:]}: rows of M={ms[0]} bitwise "
                f"equal rows of M=" + "/".join(map(str, ms[1:])))
    # the value-only layout (bf16 payload, unit scales) through the same
    # kernel, at the widest shape
    from repro_torch.kernels import ops
    name, K, N = max(_path_shapes(cfg), key=lambda s: s[2])
    w = (torch.randn((1, K, N), generator=gen) * K ** -0.5).to(dev)
    p = ops.slice_joint_stacked(ops.pack_joint_sparse_stacked(
        w, value_sparsity=cfg.dbpim_value_sparsity, payload="bf16",
        **_tiles(K, N)), 0)
    x = torch.randn((256, K), generator=gen).to(torch.bfloat16).to(dev)
    y = jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales)
    torch.cuda.synchronize()
    ref = jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx, p.scales)
    peak = ref.float().abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    assert p.w_blocks.dtype == torch.bfloat16 and err <= _bf16_ulp(peak)
    log(f"[kernel] {name} {K}x{N} bf16 payload (value mode) M=256: "
        f"max|d|={err:.3e} (tol {_bf16_ulp(peak):.3e})")
    return worst_bf16


def _int8_extremes(x):
    """x (M, K) int32 with the ends of the int8 range in it: columns 0 and
    1 of every row at -128 and 127, and (for M >= 4) rows 2 and 3 all -128
    and all 127, the largest sums the datapath adds."""
    x[:, 0], x[:, 1] = -128, 127
    if x.shape[0] >= 4:
        x[2], x[3] = -128, 127
    return x


def _err_tol(y, ref):
    """(max abs error, tolerance): 1e-5 of the peak for f32 outputs, one
    bf16 ulp of the peak for bf16 outputs."""
    peak = ref.float().abs().max().item()
    err = (y.float() - ref.float()).abs().max().item()
    tol = F32_TOL * peak if y.dtype == torch.float32 else _bf16_ulp(peak)
    return err, tol


def phase_kernel_value_bit_dbmu(cfg, dev):
    """The block-sparse, FTA/INT8 and DBMU kernels against their plain
    versions at every projection shape, M in {4, 256}, on weights packed as
    the per-layer hook and the pipeline pack them (block-sparse and FTA
    packs made on the card equal the CPU's). Returns the worst abs error
    of the bf16 outputs per kernel (DBMU: 0, or the run fails)."""
    from repro_torch.core import dyadic
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import dbmu_sim
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(5)
    worst = {"block_sparse_matmul": 0.0, "fta_int8_matmul": 0.0,
             "dbmu_matmul": 0.0}
    for name, K, N in _distinct(_path_shapes(cfg)):
        w = torch.randn((K, N), generator=gen) * K ** -0.5
        mask = ops.tile_prune_mask(w, cfg.dbpim_value_sparsity)
        wb_cpu, idx_cpu = ops.pack_block_sparse(w * mask, torch.ones_like(mask))
        wd = w.to(dev)
        md = ops.tile_prune_mask(wd, cfg.dbpim_value_sparsity)
        wb, idx = ops.pack_block_sparse(wd * md, torch.ones_like(md))
        assert torch.equal(md.cpu(), mask) and torch.equal(wb.cpu(), wb_cpu) \
            and torch.equal(idx.cpu(), idx_cpu), (name, "block-sparse pack")
        ones = torch.ones((K, N), dtype=torch.int32)
        q, sc = ops.quantize_int8_fta(wd, ones.to(dev))
        q_cpu, sc_cpu = ops.quantize_int8_fta(w, ones)
        assert torch.equal(q.cpu(), q_cpu) and torch.equal(sc.cpu(), sc_cpu)
        q = q.to(torch.int8)
        packed = dyadic.pack_terms(q)
        errs = {k: [] for k in worst}
        heads = {}
        for dt in (torch.float32, torch.bfloat16):
            x256 = torch.randn((256, K), generator=gen).to(dt).to(dev)
            for M in (4, 256):
                x = x256[:M].contiguous()
                y = bsk.block_sparse_matmul(x, wb.to(dt), idx)
                torch.cuda.synchronize()
                err, tol = _err_tol(y, bsk.block_sparse_matmul_plain(
                    x, wb.to(dt), idx))
                assert err <= tol, (name, "block_sparse", dt, M, err, tol)
                errs["block_sparse_matmul"].append((err, tol, y.dtype))
                for od in (torch.bfloat16, torch.float32):
                    y = ftk.fta_int8_matmul(x, q, sc, od)
                    torch.cuda.synchronize()
                    err, tol = _err_tol(y, ftk.fta_int8_matmul_plain(
                        x, q, sc, od))
                    assert err <= tol, (name, "fta", dt, od, M, err, tol)
                    errs["fta_int8_matmul"].append((err, tol, od))
                    if M == 4:
                        heads[(dt, od)] = y
                    else:
                        assert torch.equal(heads[(dt, od)], y[:4]), \
                            (name, "fta rows", dt, od)
        xi256 = _int8_extremes(torch.randint(-128, 128, (256, K), generator=gen,
                                             dtype=torch.int32)).to(dev)
        for M in (4, 256):
            xi = xi256[:M].contiguous()
            y = dbmu_sim.dbmu_matmul(xi, packed)
            torch.cuda.synchronize()
            assert torch.equal(y, dbmu_sim.dbmu_matmul_plain(xi, packed)), \
                (name, "dbmu", M)
        # past the int8 range: the datapath's 8 magnitude planes read every
        # |x| <= 255 (+-200, +-255 in every row; the first K tile only, then
        # all of x)
        xw = torch.randint(-255, 256, (256, K), generator=gen,
                           dtype=torch.int32)
        xw[:, :4] = torch.tensor([200, -200, 255, -255], dtype=torch.int32)
        for what, x in (("first K tile", torch.cat(
                [xw[:, :64], xi256.cpu()[:, 64:]], dim=1)), ("all of x", xw)):
            x = x.contiguous().to(dev)
            y = dbmu_sim.dbmu_matmul(x, packed)
            torch.cuda.synchronize()
            assert torch.equal(y, dbmu_sim.dbmu_matmul_plain(x, packed)), \
                (name, "dbmu wide x", what)
        for kname, rows in errs.items():
            if not rows:
                continue
            bf = [e for e, _, od in rows if od == torch.bfloat16]
            worst[kname] = max(worst[kname], max(bf))
            log(f"[kernel] {kname} {name} {K}x{N} M in (4, 256), f32 and "
                f"bf16 x: max|d|/tol = "
                f"{max(e / t if t else float(e > 0) for e, t, _ in rows):.3f}"
                f" (bf16 out max|d|={max(bf):.3e})")
        log(f"[kernel] fta_int8_matmul {name} {K}x{N}: rows of M=4 bitwise "
            f"equal rows of M=256 (f32 and bf16 x and out)")
        log(f"[kernel] dbmu_matmul {name} {K}x{N} M in (4, 256), x with "
            f"-128 and 127, and M=256 with x in [-255, 255] (+-200 and "
            f"+-255 in every row): bitwise equal to its plain version; "
            f"block-sparse "
            f"pack (NT={wb.shape[0]}, MAXB={wb.shape[1]}) and FTA INT8 "
            f"weights card == cpu byte for byte")
    return worst


def _serve_attention_inputs(cfg, dev, dtype, gen, B=4, A=512, C=64):
    """Queries and a random cache at the serving path's attention shapes:
    a decode call (one query per slot) and a prefill-chunk call (C queries
    per slot), at positions inside the serve phase's range."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    v = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    qd = torch.randn((B, 1, H, hd), generator=gen).to(dtype).to(dev)
    qc = torch.randn((B, C, H, hd), generator=gen).to(dtype).to(dev)
    pos_d = torch.tensor([[40], [120], [200], [280]], dtype=torch.int32)
    pos_c = (torch.tensor([0, 64, 128, 192], dtype=torch.int32)[:, None]
             + torch.arange(C, dtype=torch.int32)[None])
    return dict(k=k, v=v, decode=(qd, pos_d[:B].to(dev)),
                chunk=(qc, pos_c[:B].to(dev)))


def _long_attention_inputs(cfg, dev, dtype, gen, B=LONG_B, A=LONG_A,
                           C=LONG_C):
    """Queries and a random cache at the long-context serve cell's shape:
    a prefill-chunk call of C queries per slot, slot b's chunk starting at
    position C * (b mod 6) (chunks 0 to 5 of prompts up to 1536 tokens)."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    v = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    q = torch.randn((B, C, H, hd), generator=gen).to(dtype).to(dev)
    pos = (C * (torch.arange(B, dtype=torch.int32) % 6)[:, None]
           + torch.arange(C, dtype=torch.int32)[None])
    return dict(k=k, v=v, long=(q, pos.to(dev)))


def _stream_attention_inputs(cfg, dev, dtype, gen, A, B=1, C=STREAM_C):
    """Queries and a random cache of A slots, past the limit of the
    resident logits: C queries per slot at the end of the cache, so every
    key is live for the last query (slot 0), and, for a second slot,
    positions spread over the cache."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    k = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    v = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    q = torch.randn((B, C, H, hd), generator=gen).to(dtype).to(dev)
    pos = [A - C + torch.arange(C, dtype=torch.int32),
           torch.linspace(0, A - 1, C).to(torch.int32)][:B]
    return dict(k=k, v=v, stream=(q, torch.stack(pos).to(dev)))


def phase_kernel_rows(cfg, dev, norm_widths):
    """row_attention and row_norm against their plain versions at the
    serving shapes (row_norm at every served width in ``norm_widths``:
    tinyllama's d_model, mamba2's gated-norm d_in, ..., qwen3's qk-norm
    over its head dim; RMSNorm, gemma's (1 + w) RMSNorm and LayerNorm
    with a bias at each), and their row stability: a query (row) alone
    comes out bitwise equal to the same query (row) in a chunk call.
    Returns the worst abs error of the bf16 outputs per kernel."""
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    gen = torch.Generator().manual_seed(8)
    worst = {"row_attention": 0.0, "row_norm": 0.0}
    for dt in (torch.bfloat16, torch.float32):
        serve = _serve_attention_inputs(cfg, dev, dt, gen)
        long = _long_attention_inputs(cfg, dev, dt, gen)
        for what, a in (("decode", serve), ("chunk", serve), ("long", long)):
            q, pos = a[what]
            y = rak.row_attention(q, a["k"], a["v"], pos)
            torch.cuda.synchronize()
            ref = rak.row_attention_plain(q, a["k"], a["v"], pos)
            peak = ref.float().abs().max().item()
            err = (y.float() - ref.float()).abs().max().item()
            tol = (F32_TOL if dt == torch.float32 else ATTN_REL_TOL) * peak
            assert torch.isfinite(y).all() and err <= tol, \
                ("row_attention", what, dt, err, tol)
            if dt == torch.bfloat16:
                worst["row_attention"] = max(worst["row_attention"], err)
            log(f"[kernel] row_attention {what} {tuple(q.shape)} x cache "
                f"{tuple(a['k'].shape)} {str(dt)[6:]}: max|d|={err:.3e} "
                f"(tol {tol:.3e})")
            del y, ref
        for what, a, ts in (("chunk", serve, (0, 31, 63)),
                            ("long", long, (0, 127, 255))):
            q, pos = a[what]
            y = rak.row_attention(q, a["k"], a["v"], pos)
            for t in ts:
                one = rak.row_attention(q[:, t:t + 1].contiguous(), a["k"],
                                        a["v"], pos[:, t:t + 1].contiguous())
                assert torch.equal(one, y[:, t:t + 1]), \
                    ("row_attention rows", what, t)
            log(f"[kernel] row_attention {str(dt)[6:]}: queries "
                f"{', '.join(map(str, ts))} of the {what} call bitwise equal "
                f"to one-query calls")
        del long
        A = STREAM_A_BF16 if dt == torch.bfloat16 else STREAM_A_F32
        a = _stream_attention_inputs(cfg, dev, dt, gen, A, B=2, C=8)
        q, pos = a["stream"]
        assert rak.streams(A, cfg.hd, dt)
        y = rak.row_attention(q, a["k"], a["v"], pos)
        torch.cuda.synchronize()
        ref = rak.row_attention_plain(q, a["k"], a["v"], pos)
        peak = ref.float().abs().max().item()
        err = (y.float() - ref.float()).abs().max().item()
        tol = (F32_TOL if dt == torch.float32 else ATTN_REL_TOL) * peak
        assert torch.isfinite(y).all() and err <= tol, \
            ("row_attention streaming", dt, err, tol)
        if dt == torch.bfloat16:
            worst["row_attention"] = max(worst["row_attention"], err)
        for t in (0, 3, 7):
            one = rak.row_attention(q[:, t:t + 1].contiguous(), a["k"],
                                    a["v"], pos[:, t:t + 1].contiguous())
            assert torch.equal(one, y[:, t:t + 1]), ("streaming rows", t)
        log(f"[kernel] row_attention streaming {tuple(q.shape)} x cache "
            f"{tuple(a['k'].shape)} {str(dt)[6:]} (past the resident "
            f"logits' limit): max|d|={err:.3e} (tol {tol:.3e}); queries 0, "
            f"3, 7 bitwise equal to one-query calls")
        del a, y, ref
        for D in norm_widths:
            x4096 = torch.randn((4096, D), generator=gen).to(dt).to(dev)
            scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(dev)
            bias = (0.1 * torch.randn((D,), generator=gen)).to(dev)
            for b, kind, one in ((None, "rms", False),
                                 (None, "rms (1 + w)", True),
                                 (bias, "layernorm", False)):
                for R in (4, 256, 4096):
                    x = x4096[:R].contiguous()
                    y = rnk.row_norm(x, scale, b, plus_one=one)
                    torch.cuda.synchronize()
                    err, tol = _err_tol(y, rnk.row_norm_plain(
                        x, scale, b, plus_one=one))
                    assert err <= tol, ("row_norm", kind, D, dt, R, err, tol)
                    if dt == torch.bfloat16:
                        worst["row_norm"] = max(worst["row_norm"], err)
                    if R == 4:
                        head = y
                    else:
                        assert torch.equal(head, y[:4]), \
                            ("row_norm rows", kind, D)
                    log(f"[kernel] row_norm {kind} ({R}, {D}) "
                        f"{str(dt)[6:]}, f32 scale: max|d|={err:.3e} "
                        f"(tol {tol:.3e})")
            log(f"[kernel] row_norm d={D} {str(dt)[6:]}: rows of R=4 "
                f"bitwise equal rows of R=256 and R=4096")
    return worst


@contextlib.contextmanager
def plain_versions():
    """The same model with every kernel of the serving path and the
    per-layer hook swapped for its plain version (the references of phases
    4 and 5)."""
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    swaps = [(ops, "joint_sparse_matmul", jsm.joint_sparse_matmul_plain),
             (ops, "block_sparse_matmul", bsk.block_sparse_matmul_plain),
             (ops, "fta_int8_matmul", ftk.fta_int8_matmul_plain),
             (rak, "row_attention", rak.row_attention_plain),
             (rnk, "row_norm", rnk.row_norm_plain)]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, plain in swaps:
        setattr(mod, attr, plain)
    try:
        yield
    finally:
        for mod, attr, kernel in saved:
            setattr(mod, attr, kernel)


@contextlib.contextmanager
def _final_norm_inputs(params):
    """Records the input of the final norm of every decode call (the
    residual stream after the last layer) into the list it yields."""
    from repro_torch.models import decode
    rows, norm = [], decode.apply_norm

    def f(p, x, cfg):
        if p is params["final_norm"]:
            rows.append(x)
        return norm(p, x, cfg)
    decode.apply_norm = f
    try:
        yield rows
    finally:
        decode.apply_norm = norm


@contextlib.contextmanager
def _routing(replay=None):
    """MoE routing, call by call: records each ``moe._route`` call's top-k
    indices into the dict it yields (``idx``), or, given ``replay`` (such
    a list, from the same calls of another run), routes each call to the
    replayed indices, its gate values this run's router probabilities at
    them, renormalized as ``_route`` does; ``flips`` counts the tokens
    whose own choices differed. A replay must cover every call."""
    from repro_torch.models import moe
    route = moe._route
    seen = {"idx": [], "flips": 0}

    def f(xg, router, k):
        probs, vals, idx = route(xg, router, k)
        if replay is not None:
            want = replay[len(seen["idx"])]
            seen["flips"] += int((idx != want).any(-1).sum())
            idx = want
            vals = torch.gather(probs, -1, idx)
            vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
        seen["idx"].append(idx)
        return probs, vals, idx
    moe._route = f
    try:
        yield seen
    finally:
        moe._route = route
    assert replay is None or len(seen["idx"]) == len(replay)


def _stack_out(engine, x, token):
    """What the layers added to the last token's residual stream: the
    final norm's input row minus the token's embedding, f32 on the host.
    With tied embeddings the first-token logits are dominated by the
    embedding's product with itself (the echo of the last input token),
    which no layer computes; this row is what the layers did."""
    from repro_torch.models.layers import embed_tokens
    tok = torch.tensor([[token]], dtype=torch.int32, device=engine.device)
    e = embed_tokens(engine.params["embed"], tok, engine.cfg)[0, 0]
    return (x.float() - e.float()).cpu()


def _enc_row(engine, slot=0):
    """Slot ``slot``'s row of an enc-dec engine's encoder output, (1, Se,
    D); None for a decoder-only model."""
    enc = engine.cache.get("enc_out")
    return None if enc is None else enc[slot:slot + 1]


def _chunked_run(engine, tables, prompt, chunk, cfg=None, slot=0):
    """A prompt through functional ``decode_chunk`` calls at batch 1 on a
    fresh cache (an enc-dec model's holding ``slot``'s encoder row): (the
    first-token logits, f32 on the host; the cache; the last token's
    ``_stack_out``)."""
    from repro_torch.models import decode_chunk, init_cache
    cfg = cfg or engine.cfg
    cache = init_cache(cfg, 1, engine.max_len, device=engine.device,
                       enc_out=_enc_row(engine, slot))
    cache["pos"] = torch.zeros((1,), dtype=torch.int32, device=engine.device)
    lg = part = None
    with _final_norm_inputs(engine.params) as rows:
        for s in range(0, len(prompt), chunk):
            part = prompt[s:s + chunk]
            toks = torch.zeros((1, chunk), dtype=torch.int32)
            toks[0, :len(part)] = torch.tensor(part, dtype=torch.int32)
            lg, cache = decode_chunk(
                engine.params, cache, toks.to(engine.device),
                torch.tensor([len(part)], dtype=torch.int32,
                             device=engine.device), cfg, tables=tables)
    stack = _stack_out(engine, rows[-1][0, len(part) - 1], prompt[-1])
    return lg[0, 0].float().cpu(), cache, stack


def _counted_run(engine, trace, fresh):
    """The main path: ``trace`` through the compiled ``engine`` under
    torch.profiler. Its wrappers count the eager first call of each step
    kind (the capture and the replays launch nothing the host sees); every
    launch, replays included, is read from torch.profiler's device-side
    records by the kernels' symbols, and must be ``obs.per_call`` of each
    kernel per device call, with no other kernel of the port. The profiler
    now and then loses records (a window with none, or a call short of
    kernels it ran); such a run is taken again with a ``fresh()`` engine,
    and the phase fails if no run of three counts every launch. Returns
    (engine, outputs, device launches, host launches, peak GiB)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.obs import device_launches
    dev = engine.device
    per_call = obs.per_call(engine.cfg)
    # the block-sparse matmul shares the joint kernel's symbols; the eager
    # runs' host counts stand for it
    recorded = {name: mod for name, mod in _kernel_modules().items()
                if name != "block_sparse_matmul"}
    for attempt in range(3):
        if attempt:
            engine = fresh()
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _pad()
            outputs = engine.run(trace)
            _pad()
        counts = read_launches()
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        calls = engine.metrics.summary()["device_calls"]
        device = device_launches(prof, recorded)
        want = {name: per_call.get(name, 0) * calls for name in device}
        if device == want:
            return engine, outputs, device, counts, peak_gib
        log(f"[serve] compiled run {attempt + 1}: the profiler's device "
            f"records count {device}, not {want}; taken again")
    raise AssertionError(f"device launches of the compiled serve run: "
                         f"{device} != {want} in 3 runs")


def phase_serve(dev, serve_args=SERVE_ARGS,
                prefill_kind="prefill_chunk_exact", tag="serve", built=None):
    """One model served at full width through the compiled engine and an
    eager one on the same trace (``serve_args``: tinyllama-1.1b, or
    mamba2-1.3b with its parallel SSD chunks, ``prefill_kind``; or
    whisper-base, whose engines share the encoder's output; or
    pixtral-12b, text-only). ``built``: the serve CLI's (engine, trace,
    tables) for ``serve_args``, when the caller has built them. Returns
    (device launches per kernel over the compiled run, the two engines,
    the stacked tables)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch import obs
    from repro_torch.obs import RecompileSentinel
    from repro_torch.serving import ServeEngine
    args = serve.build_parser().parse_args(serve_args)
    cfg = get_config(args.arch, reduced=args.reduced,
                     dbpim_mode=args.dbpim_mode)
    t0 = time.monotonic()
    engine, trace, tables = built or serve.build_engine_and_trace(args, cfg)
    torch.cuda.synchronize()
    log(f"[{tag}] params + stacked tables on the card "
        + ("(built before) " if built else
           f"in {time.monotonic() - t0:.2f} s ")
        + f"({cfg.name}, {cfg.n_layers} layers, "
        f"d={cfg.d_model}, d_ff={cfg.d_ff}, dtype={cfg.dtype}); resident "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB")
    # the same trace through the same params and tables with the in-place
    # steps run eagerly: what the compiled engine's graphs must reproduce;
    # every launch is a host launch here, so the wrappers' counts see all
    enc_out = engine.cache.get("enc_out")
    eager = ServeEngine(cfg, engine.params, n_slots=args.batch,
                        max_len=args.max_len,
                        prefill_chunk=args.prefill_chunk,
                        stacked_tables=tables, enc_out=enc_out, device=dev,
                        cuda_graphs=False)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    eager_outputs = eager.run(trace)
    torch.cuda.synchronize()
    eager_counts = read_launches()
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # the main path: the compiled engine
    per_call = obs.per_call(cfg)    # tinyllama 154/22/45, mamba2 96/0/97
    engine, outputs, device, counts, peak_gib = _counted_run(
        engine, trace, lambda: ServeEngine(
            cfg, engine.params, n_slots=args.batch, max_len=args.max_len,
            prefill_chunk=args.prefill_chunk, stacked_tables=tables,
            enc_out=enc_out, device=dev))
    calls = engine.metrics.summary()["device_calls"]
    kind = prefill_kind
    assert engine.prefill_kind == eager.prefill_kind == kind, \
        engine.prefill_kind
    check_waterfall(engine, tables, tag)
    keys = {RecompileSentinel.key(k, cfg.name): 1
            for k in ("decode", kind, "reset")}
    assert engine.sentinel.counts() == keys, engine.sentinel.counts()
    assert eager.sentinel.counts() == keys, eager.sentinel.counts()
    assert outputs == eager_outputs, "compiled vs eager greedy streams"
    assert set(engine.first_logits) == set(eager.first_logits)
    for rid, row in engine.first_logits.items():
        assert torch.equal(row, eager.first_logits[rid]), rid
    log(f"[{tag}] compiled engine (one CUDA graph per step kind) vs the "
        f"eager in-place steps on the same trace: all {len(outputs)} greedy "
        f"streams and first-token logits bitwise equal; recompile sentinel "
        + ", ".join(f"{k}={n}" for k, n in engine.sentinel.counts().items())
        + " compiled signature(s)")
    s = engine.metrics.summary()
    e_s = eager.metrics.summary()
    assert s["n_completed"] == len(trace) == 8, s["n_completed"]
    assert all(len(outputs[r.rid]) == r.gen_len for r in trace)
    assert e_s["device_calls"] == calls == s["device_calls"]
    # the host: every launch of the eager run; of the compiled run, the
    # first decode and the first prefill-chunk call's (the warm-ups)
    assert eager_counts == {name: per_call.get(name, 0) * calls
                            for name in eager_counts}, (eager_counts, calls)
    assert counts == {name: 2 * per_call.get(name, 0)
                      for name in counts}, counts
    launches = {name: device[name] for name in per_call}
    lat = s["call_latency_ms"]
    e_lat = e_s["call_latency_ms"]
    log(f"[{tag}] {s['n_completed']}/{s['n_requests']} requests, "
        f"{s['generated_tokens']} tokens, {s['engine_ticks']} ticks, "
        f"{s['decode_calls']} decode + {s['prefill_calls']} prefill calls; "
        f"device kernel launches (torch.profiler, graph replays included) "
        + ", ".join(f"{name} {launches[name]} == {n} x {calls}"
                    for name, n in per_call.items())
        + " (the port's other kernels: 0); host-counted launches: eager run "
        + ", ".join(f"{name} {eager_counts[name]}" for name in per_call)
        + ", compiled run " + ", ".join(f"{name} {counts[name]}"
                                        for name in per_call)
        + " (the first decode and prefill-chunk calls' warm-ups)")
    for what, summ, ls, peak in (
            ("compiled (under torch.profiler)", s, lat, peak_gib),
            ("eager", e_s, e_lat, eager_peak)):
        log(f"[{tag}] {cfg.name} {what}: {summ['tokens_per_sec']:.1f} "
            f"tokens/s over {summ['wall_s']:.2f} s; decode ms/step "
            f"p50={ls['decode']['p50_ms']:.2f} "
            f"mean={ls['decode']['mean_ms']:.2f}; {kind} "
            f"p50={ls[kind]['p50_ms']:.2f} "
            f"mean={ls[kind]['mean_ms']:.2f} ms; peak "
            f"device memory {peak:.3f} GiB (the compiled run's includes "
            f"its three captures)")
    # with tied embeddings (mamba2, gemma) the logits' peak is the echo of
    # the last prompt token, which no layer computes: the scale is then
    # the peak of the other entries, and the layers' output (_stack_out)
    # of the kernel path's chunks is held to the plain path's as well
    # (mamba2; gemma's is printed)
    slot_of = {iv.rid: iv.slot for iv in engine.slot_log}
    for rid in (0, 1):
        prompt = list(trace[rid].prompt)
        with plain_versions():
            ref = _chunked_run(engine, tables, prompt, engine.prefill_chunk,
                               slot=slot_of[rid])
        row = engine.first_logits[rid]
        assert row.shape == (1, cfg.vocab_size), row.shape
        assert row.dtype == torch.bfloat16 and row.device.type == "cpu"
        got = row[0].float()
        d = (got - ref[0]).abs().max().item()
        others = torch.ones_like(got, dtype=torch.bool)
        if cfg.tie_embeddings:
            others[prompt[-1]] = False
        peak = ref[0][others].abs().max().item()
        assert torch.isfinite(got).all()
        assert d <= LOGIT_REL_TOL * peak, (rid, d, peak)
        log(f"[{tag}] request {rid} (prompt {len(prompt)}): first-token "
            f"logits (1, V) bf16 row, kernel vs plain max|d|={d:.3e} (tol "
            f"{LOGIT_REL_TOL} x {peak:.3f}, max|ref|"
            + (f" past the echo {ref[0][prompt[-1]].item():.3f} of the last "
               f"token)" if cfg.tie_embeddings else ")"))
        if cfg.tie_embeddings:
            # gemma's residual stream carries its embedding scaled by
            # sqrt(d): a bf16 step of the stream (0.5 at 64..128) is a
            # large part of what its layers add, so there the gap is
            # printed, not bounded
            stack = _chunked_run(engine, tables, prompt,
                                 engine.prefill_chunk)[2]
            sd = (stack - ref[2]).abs().max().item()
            speak = ref[2].abs().max().item()
            bounded = not cfg.embed_scale
            assert not bounded or sd <= LOGIT_REL_TOL * speak, \
                (rid, sd, speak)
            log(f"[{tag}] request {rid}: the layers' output of its chunks "
                f"(batch 1), kernel vs plain max|d|={sd:.3e} "
                + (f"(tol {LOGIT_REL_TOL} x {speak:.3f})" if bounded else
                   f"of its peak {speak:.3f} (printed, not bounded: the "
                   f"residual stream's bf16 step at the scaled embedding's "
                   f"size)"))
    if cfg.family != "ssm":
        check_chunk_equals_stepwise(engine, tables, list(trace[0].prompt),
                                    tag=tag)
    return launches, engine, eager, tables


#: the dry-run cells phase 4m reckons on meta tensors
MESH_DRYRUN_CELLS = (("tinyllama-1.1b", "decode_32k"),
                     ("tinyllama-1.1b", "prefill_32k"))


def phase_mesh(dev, served, tables):
    """Phase 4m: phase 4's trace through an engine on an explicit one-card
    mesh (streams bitwise phase 4's ``served`` engine's, the same device
    launches), then the dry run's cells on meta tensors with device
    memory unchanged. Returns the device launches of the meshed run."""
    import tempfile

    from repro_torch import obs
    from repro_torch.launch import dryrun, roofline, serve
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import build_slot_decode_step
    from repro_torch.runtime import sharding as shr
    from repro_torch.serving import ServeEngine
    t0 = time.monotonic()
    args = serve.build_parser().parse_args(SERVE_ARGS)
    cfg = served.cfg
    trace = serve.trace_from_args(args, cfg.vocab_size)
    mesh = make_test_mesh()
    assert mesh.device == torch.device("cuda", torch.cuda.current_device())

    def fresh():
        return ServeEngine(cfg, served.params, mesh=mesh, n_slots=args.batch,
                           max_len=args.max_len,
                           prefill_chunk=args.prefill_chunk,
                           stacked_tables=tables, device=dev)
    engine, outputs, device, counts, _ = _counted_run(fresh(), trace, fresh)
    assert outputs == served.outputs, "streams under the explicit mesh"
    per_call = obs.per_call(cfg)
    calls = engine.metrics.summary()["device_calls"]
    assert device == {name: per_call.get(name, 0) * calls
                      for name in device}, (device, calls)
    assert counts == {name: 2 * per_call.get(name, 0) for name in counts}, \
        counts
    assert engine.mesh is mesh and engine.prefill_kind == "prefill_chunk_exact"
    _, shard_fn = build_slot_decode_step(cfg, mesh, stacked_tables=tables)
    specs = shard_fn(engine.params, engine.cache,
                     torch.zeros((args.batch, 1), dtype=torch.int32,
                                 device=dev),
                     torch.zeros((args.batch,), dtype=torch.bool, device=dev))
    leaves = [spec for tree in specs
              for _, spec in shr.tree_leaves_with_path(tree)]
    named = sum(1 for spec in leaves
                if any(a in ("model", "data") for e in spec if e is not None
                       for a in (e if isinstance(e, tuple) else (e,))))
    log(f"[mesh] {cfg.name} through ServeEngine(mesh=make_test_mesh()) "
        f"{mesh.shape} on {mesh.device}: {len(outputs)} greedy streams "
        f"bitwise phase 4's; device launches "
        + ", ".join(f"{k} {device[k]}" for k in per_call)
        + f" == phase 4's per call x {calls} calls; {named} of "
        f"{len(leaves)} spec leaves of the decode step name model or data "
        f"(axes of size 1: no operand moves); "
        f"{time.monotonic() - t0:.1f} s")
    smi = _smi()
    for arch, shape in MESH_DRYRUN_CELLS:
        t1 = time.monotonic()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        with tempfile.TemporaryDirectory() as tmp:
            rec = dryrun.run_cell(arch, shape, "single", out_dir=Path(tmp),
                                  verbose=False)
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated(dev)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["collectives"] is None, rec["collectives"]
        assert before == after, (arch, shape, before, after)
        jc = rec["jaxpr_cost"]
        assert jc["weight_bytes"] > 0 and jc["dot_flops"] > 0, jc
        row = roofline.format_table([roofline.analyze_record(rec)],
                                    "single").splitlines()[-1]
        log(f"[mesh] dry run {arch} x {shape} x single {rec['mesh_shape']} "
            f"on meta: dot FLOPs {jc['dot_flops']:.4e}, flops "
            f"{jc['flops']:.4e}, weight bytes {jc['weight_bytes']:.4e}, "
            f"argument bytes a device "
            f"{rec['memory_analysis']['argument_size_in_bytes'] / 1e9:.3f} "
            f"GB; device memory allocated {before} B before and after; "
            f"{time.monotonic() - t1:.1f} s")
        log(f"[mesh] roofline ({smi}): {row.strip()}")
    log(f"[mesh] phase 4m in {time.monotonic() - t0:.1f} s")
    return device


class OpTrace:
    """Records the output of every op of the decode path (embedding,
    norms, projections, RoPE, attention, MLP; the MoE's gate values,
    expert projections, dense residual MLP and block output; logits),
    labelled with its layer, one list per decode_step / decode_chunk
    call."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.calls = []
        self._layer = -1
        self._token = None      # the token step of an exact SSM chunk
        self._steps = None      # token steps taken in the current one

    def _record(self, name, out):
        self.calls[-1].append((name, self._token, out))
        return out

    @contextlib.contextmanager
    def recording(self):
        from repro_torch.models import (attention, decode, moe, ssm,
                                        transformer)
        from repro_torch.sparsity import sparse_linear
        patches = []

        def patch(mod, attr, wrapper):
            patches.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrapper(getattr(mod, attr)))

        def at_layer(name):
            def wrapper(fn):
                def f(*a, **kw):
                    return self._record(f"L{self._layer} {name}", fn(*a, **kw))
                return f
            return wrapper

        def embed(fn):
            def f(*a, **kw):
                self.calls.append([])
                self._layer = -1
                return self._record("embed", fn(*a, **kw))
            return f

        def norm1(fn):
            def f(*a, **kw):
                self._layer += 1
                name = ("final_norm" if self._layer == self.n_layers
                        else f"L{self._layer} norm1")
                return self._record(name, fn(*a, **kw))
            return f

        def dense_fn(method):
            def f(tables_self, slices):
                mm = method(tables_self, slices)

                def rec(w, x, name):
                    return self._record(f"L{self._layer} {name}", mm(w, x, name))

                def expert(w, x, name):
                    # (G, E, C, N) with G the chunk position: token first
                    out = mm.expert(w, x, name)
                    self._record(f"L{self._layer} {name}", out.transpose(0, 1))
                    return out
                rec.expert = expert
                return rec
            return f

        def moe_block(fn):
            def f(*a, **kw):
                y, aux = fn(*a, **kw)
                self._record(f"L{self._layer} moe", y)
                return y, aux
            return f

        def route(fn):
            def f(*a, **kw):
                probs, vals, idx = fn(*a, **kw)
                # (G, Tg, k) gate values, G the chunk position: token first
                self._record(f"L{self._layer} gates", vals.transpose(0, 1))
                return probs, vals, idx
            return f

        def exact_chunk(fn):
            # an exact SSM chunk: one decode_ssm step per token, each one's
            # ops tagged with its token
            def f(*a, **kw):
                self._steps = 0
                try:
                    return fn(*a, **kw)
                finally:
                    self._steps = None
            return f

        def ssm_step(fn):
            # decode_ssm's output, conv window and state (its in_proj and
            # out_proj are recorded through the tables' hook)
            def f(*a, **kw):
                if self._steps is not None:
                    self._token, self._steps = self._steps, self._steps + 1
                try:
                    y, conv, state = fn(*a, **kw)
                    for name, t in (("ssm y", y), ("conv", conv),
                                    ("state", state)):
                        self._record(f"L{self._layer} {name}", t)
                    return y, conv, state
                finally:
                    self._token = None
            return f

        patch(decode, "embed_tokens", embed)
        patch(decode, "apply_norm", norm1)
        patch(decode, "logits_from_hidden", at_layer("logits"))
        patch(transformer, "apply_norm", at_layer("norm2"))
        patch(transformer, "apply_mlp", at_layer("mlp"))
        patch(attention, "apply_rope", at_layer("rope"))
        patch(attention, "_sdpa", at_layer("sdpa"))
        patch(sparse_linear.StackedKernelTables, "dense_fn", dense_fn)
        patch(moe, "apply_moe_block", moe_block)
        patch(moe, "_route", route)
        patch(moe, "apply_mlp", at_layer("dense_mlp"))
        patch(ssm, "prefill_ssm", exact_chunk)
        patch(ssm, "decode_ssm", ssm_step)
        try:
            yield self
        finally:
            for mod, attr, orig in reversed(patches):
                setattr(mod, attr, orig)


def _first_parting(chunk_call, step_calls):
    """Ops (label, max|d|) where a one-chunk prefill and stepwise decode
    of the same tokens differ, in the order the model runs them. Token t of
    the chunk's output (dim 1) is compared with step t's; the logits, which
    the chunk gives for its last token only, with the last step's; an op of
    an exact SSM chunk's token step t (its projections, output, conv window
    and state) with the same op of step t; cross-attention's k/v
    projections of the encoder rows whole, with every step's. An op
    recorded more than once a layer (both norms of a cross-attention
    layer, both attentions) is matched by its occurrence."""
    def keyed(call):
        seen, out = {}, {}
        for label, token, t in call:
            n = seen.get((label, token), 0)
            seen[(label, token)] = n + 1
            out[(label, token, n)] = t
        return out

    steps = [keyed(call) for call in step_calls]
    for step in steps[1:]:
        assert step.keys() == steps[0].keys()
    chunk = keyed(chunk_call)
    assert {(lab, n) for lab, _, n in chunk} == \
        {(lab, n) for lab, _, n in steps[0]}
    parted = []
    for (label, token, n), tc in chunk.items():
        key = (label, None, n)
        if token is not None:
            pairs = [(tc, steps[token][key])]
        elif label.endswith("logits"):
            pairs = [(tc[:, 0], steps[-1][key][:, 0])]
        elif label.endswith(("xattn/wk", "xattn/wv")):
            pairs = [(tc, step[key]) for step in steps]
        else:
            pairs = [(tc[:, t], step[key][:, 0])
                     for t, step in enumerate(steps)]
        if not all(torch.equal(a, b) for a, b in pairs):
            d = max((a.float() - b.float()).abs().max().item()
                    for a, b in pairs)
            parted.append((label, d))
    return parted


def check_chunk_equals_stepwise(engine, tables, prompt, cfg=None,
                                chunk=None, tag="serve"):
    """Chunked prefill == stepwise decode at model level on the card
    (kernel path, batch 1): op by op through every layer over one chunk
    (``cfg`` may be the engine's with ``prefill_exact``; ``chunk``
    defaults to the engine's), then the first-token logits and every
    cache leaf of the whole prompt. Fails naming the first op where the
    two paths part."""
    cfg = cfg or engine.cfg
    C = chunk or engine.prefill_chunk
    part = prompt[:C]
    trace = OpTrace(cfg.n_layers)
    with trace.recording():
        _chunked_run(engine, tables, part, C, cfg)
        _stepwise_run(engine, tables, part)
    assert len(trace.calls) == 1 + len(part)
    parted = _first_parting(trace.calls[0], trace.calls[1:])
    n_ops = len(trace.calls[0])
    if parted:
        worst = max(parted, key=lambda p: p[1])
        log(f"[{tag}] chunked prefill vs stepwise decode ({len(part)} "
            f"tokens, batch 1): {len(parted)} of {n_ops} ops differ; first "
            f"{parted[0][0]} max|d|={parted[0][1]:.3e}; largest {worst[0]} "
            f"max|d|={worst[1]:.3e}")
    assert not parted, parted[:3]
    log(f"[{tag}] chunked prefill vs stepwise decode ({len(part)} tokens, "
        f"batch 1): all {n_ops} ops bitwise equal, token by token, through "
        f"all {cfg.n_layers} layers")
    del trace
    chunked, c_cache, _ = _chunked_run(engine, tables, prompt, C, cfg)
    stepwise, s_cache, _ = _stepwise_run(engine, tables, prompt)
    assert torch.equal(chunked, stepwise), \
        (chunked - stepwise).abs().max().item()
    leaves = _flat(s_cache)
    for path, leaf in _flat(c_cache).items():
        assert torch.equal(leaf, leaves[path]), path
    log(f"[{tag}] a prompt of {len(prompt)} tokens in "
        f"{-(-len(prompt) // C)} chunks of {C}: first-token logits and all "
        f"{len(leaves)} cache leaves bitwise equal to stepwise decode's")


def _flat(tree, path=""):
    """{'/'-joined path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _stepwise_run(engine, tables, prompt, slot=0):
    """A prompt through functional ``decode_step`` calls at batch 1 on a
    fresh cache (an enc-dec model's holding ``slot``'s encoder row): (the
    last step's logits, f32 on the host; the cache; the last token's
    ``_stack_out``)."""
    from repro_torch.models import decode_step, init_cache
    cache = init_cache(engine.cfg, 1, engine.max_len, device=engine.device,
                       enc_out=_enc_row(engine, slot))
    cache["pos"] = torch.zeros((1,), dtype=torch.int32, device=engine.device)
    with _final_norm_inputs(engine.params) as rows:
        for tok in prompt:
            lg, cache = decode_step(
                engine.params, cache,
                torch.tensor([[tok]], dtype=torch.int32,
                             device=engine.device), engine.cfg, tables=tables)
    stack = _stack_out(engine, rows[-1][0, 0], prompt[-1])
    return lg[0, 0].float().cpu(), cache, stack


def _ssm_gaps(got, ref, echo):
    """Measures of a mamba2 run against a reference run (each a
    ``_chunked_run`` / ``_stepwise_run`` result) of the same prompt, whose
    last token is ``echo``: the first-token logits as a whole, at the
    echo's entry (the tied embedding's product with itself) and at every
    other entry; the layers' output (``_stack_out``); the states, the
    worst layer relative to its own peak; the conv windows."""
    (lg, cg, sg), (lr, cr, sr) = got, ref
    d = (lg - lr).abs()
    rest = torch.ones_like(d, dtype=torch.bool)
    rest[echo] = False
    ds = (cg["ssm"]["state"] - cr["ssm"]["state"]).abs().flatten(1)
    peaks = cr["ssm"]["state"].abs().flatten(1).amax(1).clamp_min(1e-30)
    conv_eq = [torch.equal(a, b) for a, b in zip(cg["ssm"]["conv"],
                                                  cr["ssm"]["conv"])]
    return {"bitwise": bool(torch.equal(lg, lr)),
            "logit_d": d.max().item(), "logit_peak": lr.abs().max().item(),
            "echo_ref": lr[echo].item(), "echo_d": d[echo].item(),
            "rest_d": d[rest].max().item(),
            "rest_peak": lr[rest].abs().max().item(),
            "stack_d": (sg - sr).abs().max().item(),
            "stack_peak": sr.abs().max().item(),
            "state_rel_d": (ds.amax(1) / peaks).max().item(),
            "conv_equal_layers": sum(conv_eq),
            "conv_first_layer_equal": conv_eq[0]}


def phase_ssm_exact(engine, tables):
    """mamba2's chunk forms against stepwise decode at model level (batch
    1, a SSM_PROMPT-token prompt in chunks of SSM_MODEL_CHUNK, so the last
    chunk is ragged): the exact chunk bitwise (logits, conv windows and
    states); the parallel chunk's first-token logits and the layers'
    output within tolerances relative to what the layers make, in bf16
    and in a float32 copy of the model (see below); then an exact-mode
    engine (2 requests, chunks of
    SSM_EXACT_CHUNK) compiled against the same engine run eagerly,
    bitwise, one signature per step."""
    from repro_torch.models import ssm
    from repro_torch.obs import RecompileSentinel
    from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
    cfg = engine.cfg
    exact = cfg.scaled(prefill_exact=True)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(1, cfg.vocab_size, (SSM_PROMPT,),
                           generator=gen).tolist()
    step = _stepwise_run(engine, tables, prompt)
    chunked, c_cache, _ = _chunked_run(engine, tables, prompt,
                                       SSM_MODEL_CHUNK, exact)
    assert torch.equal(chunked, step[0]), \
        (chunked - step[0]).abs().max().item()
    for key in ("conv", "state"):
        assert torch.equal(c_cache["ssm"][key], step[1]["ssm"][key]), key
    n_chunks = -(-SSM_PROMPT // SSM_MODEL_CHUNK)
    log(f"[ssm] exact chunks ({SSM_PROMPT} tokens in {n_chunks} chunks of "
        f"{SSM_MODEL_CHUNK}, batch 1): first-token logits, conv windows and "
        f"states of all {cfg.n_layers} layers bitwise equal to stepwise "
        f"decode's")
    del c_cache
    # the parallel SSD chunk reassociates the state's f32 sums (and sums
    # the bf16 conv in another order), so it is tolerance-equal to
    # stepwise decode. The reference's absolute PARALLEL_PREFILL_ATOL was
    # set on its reduced config's logits and does not hold at full width
    # (not for the reference either: tools/ssm_chunk_check.py). With the
    # tied random embedding the logits' peak is the echo of the last
    # token, which no layer computes, so the bounds take their scale from
    # what the layers make: the logits within rel x the peak of the other
    # entries, the layers' output (_stack_out) within rel x its own peak;
    # bf16 at LOGIT_REL_TOL (two bf16 paths rounding in other orders over
    # every layer), a float32 copy of the model (the SSD math alone) at
    # PARALLEL_PREFILL_ATOL["float32"], its states too, each layer
    # against its own peak. The first layer's conv window is bitwise
    # stepwise decode's in both (its input, the embedding through the
    # row-stable norm and joint kernel, is). What a planted fault reads
    # against each bound: tools/ssm_chunk_check.py --impl port, PERF.md.
    from repro_torch.launch import serve
    for dtype in ("bfloat16", "float32"):
        if dtype == "bfloat16":
            e, t = engine, tables
        else:
            args = serve.build_parser().parse_args(SSM_SERVE_ARGS)
            e, _, t = serve.build_engine_and_trace(
                args, cfg.scaled(dtype="float32"))
            step = _stepwise_run(e, t, prompt)
        g = _ssm_gaps(_chunked_run(e, t, prompt, SSM_MODEL_CHUNK), step,
                      prompt[-1])
        atol = ssm.PARALLEL_PREFILL_ATOL[dtype]
        rel = LOGIT_REL_TOL if dtype == "bfloat16" else atol
        tol = rel * max(g["rest_peak"], 1.0)
        stack_tol = rel * g["stack_peak"]
        log(f"[ssm] {dtype}: parallel chunks vs stepwise decode, "
            f"first-token logits max|d|={g['logit_d']:.3e} (tol {tol:.3e} = "
            f"{rel} x {g['rest_peak']:.3f}, the peak past the echo "
            f"{g['echo_ref']:.3f} of the last token; the reference's "
            f"absolute PARALLEL_PREFILL_ATOL[{dtype}] {atol} "
            f"{'holds' if g['logit_d'] <= atol else 'does not hold'}); "
            f"the layers' output max|d|={g['stack_d']:.3e} (tol "
            f"{stack_tol:.3e} = {rel} x {g['stack_peak']:.3f}); states "
            f"max|d| {g['state_rel_d']:.3e} of their layer's peak; first "
            f"layer's conv window bitwise equal: "
            f"{g['conv_first_layer_equal']}")
        assert g["logit_d"] <= tol, (dtype, g)
        assert g["stack_d"] <= stack_tol, (dtype, g)
        assert g["conv_first_layer_equal"], (dtype, g)
        if dtype == "float32":
            assert g["state_rel_d"] <= atol, g
        del e, t, step
    torch.cuda.empty_cache()
    trace = make_trace(WorkloadSpec(n_requests=2, arrival_rate=0.0,
                                    prompt_len=(20, 40), gen_len=(8, 8),
                                    seed=2), cfg.vocab_size)
    runs = {}
    for graphs in (True, False):
        e = ServeEngine(exact, engine.params, n_slots=2,
                        max_len=engine.max_len,
                        prefill_chunk=SSM_EXACT_CHUNK, stacked_tables=tables,
                        device=engine.device, cuda_graphs=graphs)
        runs[graphs] = (e, e.run(trace))
        torch.cuda.synchronize()
    (comp, out_c), (eag, out_e) = runs[True], runs[False]
    assert comp.prefill_kind == "prefill_chunk_exact"
    keys = {RecompileSentinel.key(k, cfg.name): 1
            for k in ("decode", "prefill_chunk_exact", "reset")}
    assert comp.sentinel.counts() == keys == eag.sentinel.counts()
    assert out_c == out_e and set(out_c) == {r.rid for r in trace}
    assert all(len(out_c[r.rid]) == r.gen_len for r in trace)
    for rid, row in comp.first_logits.items():
        assert torch.equal(row, eag.first_logits[rid]), rid
    lat = comp.metrics.summary()["call_latency_ms"]
    log(f"[ssm] exact-mode engine (prefill_exact, chunks of "
        f"{SSM_EXACT_CHUNK}, 2 requests, prompts "
        f"{[r.prompt_len for r in trace]}): compiled == eager, streams and "
        f"first-token logits bitwise; sentinel "
        + ", ".join(f"{k}={n}" for k, n in comp.sentinel.counts().items())
        + f"; prefill_chunk_exact p50 "
        f"{lat['prefill_chunk_exact']['p50_ms']:.2f} ms, p99 (the first "
        f"call's capture) {lat['prefill_chunk_exact']['p99_ms']:.1f} ms")


def _nbytes(arrays) -> int:
    """Device bytes of a tables' ``arrays`` dict (or any subset of it)."""
    return sum(a.numel() * a.element_size() for t in arrays.values()
               for a in t.values())


def _dense_rows(params):
    """The dense leaves a serving step multiplies, reckoned from the param
    tree by path, each read once a call: the unembedding ("embed/out", or
    the tied "embed/tok") and every MoE router. {path: bytes}."""
    flat = {k[1:]: v for k, v in _flat(params).items()}
    unembed = "embed/out" if "embed/out" in flat else "embed/tok"
    return {k: v.numel() * v.element_size() for k, v in flat.items()
            if k == unembed or k.endswith("moe/router")}


def check_waterfall(engine, tables, tag):
    """``obs.engine_waterfall(engine)`` on a full-width engine: under
    torch.profiler no kernel record, no wrapper launch and no device
    allocation (the peak stays at what was resident); in every call kind the rows sum to its
    weight_bytes exactly, each "tables/<family>/<part>" row (w_blocks,
    idx, scales) is that array's bytes times its reads a call (1; an
    exact chunk's SSM in/out projections C, one per token), and the other
    rows are ``_dense_rows`` of the params. Prints each kind's weight
    bytes, its bytes bound at 3.35 TB/s and the engine's measured p50 of
    that kind. Returns the waterfall (also in WATERFALLS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import engine_waterfall
    t0 = time.monotonic()
    dev, cfg = engine.device, engine.cfg
    # garbage from earlier runs may be freed during the call: the peak,
    # not the end, shows whether it allocated
    gc.collect()
    torch.cuda.synchronize()
    mem, launches = torch.cuda.memory_allocated(dev), read_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wf = engine_waterfall(engine)
        torch.cuda.synchronize()
    ran = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert not ran, ran[:8]
    assert torch.cuda.max_memory_allocated(dev) == mem, \
        (torch.cuda.max_memory_allocated(dev), mem)
    assert read_launches() == launches
    kinds = {"decode"} | ({engine.prefill_kind} if engine.prefill_kind
                          else set())
    assert set(wf) == kinds, (set(wf), kinds)
    dense = _dense_rows(engine.params)
    for kind, w in wf.items():
        rows = w["rows"]
        assert sum(rows.values()) == w["total"], kind
        want = {}
        for fam, parts in tables.arrays.items():
            ssm = fam.rsplit("/", 1)[-1] in ("in_proj", "out_proj")
            reads = (engine.prefill_chunk
                     if kind == "prefill_chunk_exact" and ssm else 1)
            for part in ("w_blocks", "idx", "scales"):
                a = parts[part]
                want[f"tables/{fam}/{part}"] = \
                    reads * a.numel() * a.element_size()
        got = {k: v for k, v in rows.items() if k.startswith("tables/")}
        assert got == want, (kind, {k: (got.get(k), want.get(k))
                                    for k in set(got) | set(want)
                                    if got.get(k) != want.get(k)})
        rest = {k: v for k, v in rows.items() if not k.startswith("tables/")}
        assert rest == dense, (kind, rest, dense)
    secs = time.monotonic() - t0
    COST_SECONDS["waterfalls"] = COST_SECONDS.get("waterfalls", 0.0) + secs
    WATERFALLS[cfg.name] = wf
    lat = engine.metrics.summary()["call_latency_ms"]
    for kind, w in wf.items():
        p50 = lat.get(kind, {}).get("p50_ms")
        tab = sum(v for k, v in w["rows"].items() if k.startswith("tables/"))
        log(f"[{tag}] {cfg.name} {kind} waterfall: {w['total']:.0f} B of "
            f"weights a call in {len(w['rows'])} rows (packed tables "
            f"{tab:.0f}, dense {w['total'] - tab:.0f}: "
            + ", ".join(sorted(dense)) + f"), summing to it exactly; bytes "
            f"bound {1e3 * w['total'] / HBM_BYTES_PER_S:.3f} ms at 3.35 "
            f"TB/s; measured p50 "
            + ("n/a" if p50 is None else f"{p50:.3f} ms") + " a call")
    log(f"[{tag}] {cfg.name} engine_waterfall: {secs:.2f} s of host time, "
        f"no kernel record, no launch, no device allocation (peak == "
        f"resident)")
    return wf


def _hand_terms(wf, tables, cfg):
    """A decode waterfall held to the hand reckoning of the same leaves:
    its table rows sum to every pack's w_blocks, idx and scales (the packs
    less nblocks, which no kernel reads), its unembedding row is 2 d V
    bytes, the rest are the routers. Returns (packs, unembedding,
    routers) in bytes."""
    rows = wf["rows"]
    packs = _nbytes({k: {p: a for p, a in t.items() if p != "nblocks"}
                     for k, t in tables.arrays.items()})
    unembed = 2 * cfg.d_model * cfg.vocab_size
    assert sum(v for k, v in rows.items() if k.startswith("tables/")) \
        == packs
    assert rows.get("embed/out", rows.get("embed/tok")) == unembed
    routers = wf["total"] - packs - unembed
    assert routers == sum(v for k, v in rows.items()
                          if k.endswith("/router"))
    return packs, unembed, routers


def phase_moe_pack(dev):
    """Grouped packs on the card: each reduced mixtral expert stack packed
    by ``pack_joint_sparse_grouped`` on the card equals the CPU pack byte
    for byte; the slice-by-slice build (``init_stacked_serving``) equals
    ``strip_packed_projections`` / ``build_stacked_tables`` of the whole
    ``init_params`` tree on the card, mixtral and arctic, reduced."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.sparsity.sparse_linear import (build_stacked_tables,
                                                    init_stacked_serving,
                                                    strip_packed_projections)
    fields = ("w_blocks", "idx", "scales", "nblocks")
    for arch in ("mixtral-8x7b", "arctic-480b"):
        cfg = get_config(arch, reduced=True, dbpim_mode="joint")
        params = init_params(cfg, seed=0, device=dev)
        for name in ("w_gate", "w_up", "w_down"):
            w = params["blocks"]["moe"][name]
            kw = dict(value_sparsity=cfg.dbpim_value_sparsity,
                      **_tiles(*w.shape[-2:]))
            card = ops.pack_joint_sparse_grouped(w, **kw)
            cpu = ops.pack_joint_sparse_grouped(w.cpu(), **kw)
            for field in fields:
                a, b = getattr(card, field).cpu(), getattr(cpu, field)
                assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
        tables = build_stacked_tables(params, cfg)
        stripped = strip_packed_projections(params, cfg)
        del params
        sliced, sliced_tables = init_stacked_serving(cfg, seed=0, device=dev)
        flat = {}

        def walk(tree, path=""):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{path}/{k}")
            else:
                flat.setdefault(path, []).append(tree)
        walk(stripped)
        walk(sliced)
        assert all(len(v) == 2 and v[0].dtype == v[1].dtype
                   and torch.equal(*v) for v in flat.values()), arch
        assert tables.static == sliced_tables.static
        for name, t in tables.arrays.items():
            for field in fields:
                assert torch.equal(t[field],
                                   sliced_tables.arrays[name][field]), \
                    (arch, name, field)
        E, L = cfg.n_experts, cfg.n_layers
        log(f"[moe] {cfg.name}: grouped packs of its {L} x {E} expert "
            f"stacks made on the card == the CPU's byte for byte; the "
            f"slice-by-slice build == the whole-stack build (params and "
            f"{len(tables.arrays)} tables) byte for byte")


def _memory_bound(cfg, tables):
    """(packs, non-expert dense weights, one layer's dense expert stacks,
    all dense expert stacks) in GiB for a MoE config's build, from the
    packed shapes: what ``init_stacked_serving`` may hold at once is the
    first three."""
    gib = 2 ** 30
    size = 2 if cfg.dtype == "bfloat16" else 4          # dense weight bytes
    non_expert = size * cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    expert_layer, experts = {}, 0
    for name, t in tables.arrays.items():
        k, n, _ = tables.static[name]
        L = t["w_blocks"].shape[0]
        if "moe/" in name:
            E = t["w_blocks"].shape[1]
            seg = name.rsplit("moe/", 1)[0]
            expert_layer[seg] = expert_layer.get(seg, 0) + size * E * k * n
            experts += size * L * E * k * n
        else:
            non_expert += size * L * k * n
    return (_nbytes(tables.arrays) / gib, non_expert / gib,
            max(expert_layer.values(), default=0) / gib, experts / gib)


def _moe_build(args, cfg, dev, tag="moe"):
    """The serve CLI's engine, trace and tables for a MoE config, built
    slice by slice on the card; prints (and bounds) the build's peak
    device memory. Returns (engine, trace, tables)."""
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    engine, trace, tables = serve.build_engine_and_trace(args, cfg)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base) / gib
    resident = (torch.cuda.memory_allocated(dev) - base) / gib
    packs, non_expert, layer, dense = _memory_bound(cfg, tables)
    experts = _nbytes({k: v for k, v in tables.arrays.items()
                       if "moe/" in k}) / gib
    bound = packs + non_expert + layer
    log(f"[{tag}] {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, "
        f"d_ff={cfg.d_ff}, {cfg.n_experts} experts): params + tables built "
        f"slice by slice on the card in {secs:.2f} s; packs {packs:.3f} "
        f"GiB (experts {experts:.3f}); build peak {peak:.3f} GiB over what "
        f"was resident before (bound: packs + non-expert dense weights "
        f"{non_expert:.3f} + one layer's dense expert stacks {layer:.3f} = "
        f"{bound:.3f}; all dense expert stacks would be {dense:.3f}); "
        f"resident after {resident:.3f} GiB (card total "
        f"{torch.cuda.memory_allocated(dev) / gib:.3f})")
    assert peak <= bound, (peak, bound)
    return engine, trace, tables


def _same_runs(comp, out_c, eag, out_e, trace, kinds):
    """Compiled vs eager engine on one trace: streams and first-token
    logits bitwise equal, every request complete, one signature a step."""
    from repro_torch.obs import RecompileSentinel
    keys = {RecompileSentinel.key(k, comp.cfg.name): 1 for k in kinds}
    assert comp.sentinel.counts() == keys == eag.sentinel.counts(), \
        (comp.sentinel.counts(), eag.sentinel.counts())
    assert out_c == out_e and set(out_c) == {r.rid for r in trace}
    assert all(len(out_c[r.rid]) == r.gen_len for r in trace)
    assert set(comp.first_logits) == set(eag.first_logits)
    for rid, row in comp.first_logits.items():
        assert torch.equal(row, eag.first_logits[rid]), rid


def _logit_gap(got, ref):
    """(max|d|, tolerance) of kernel-path logits against the plain path's:
    LOGIT_REL_TOL of the plain path's peak (the embeddings are untied)."""
    peak = ref.abs().max().item()
    assert torch.isfinite(got).all()
    return (got.float() - ref).abs().max().item(), LOGIT_REL_TOL * peak


def phase_moe_serve(dev):
    """mixtral-8x7b at full width and depth (32 layers) in joint mode,
    built slice by slice on the card (its 90 GB of dense expert stacks
    never exist), served through the compiled engine on the serve phase's
    trace; its sliding window makes the engine prefill stepwise ("full":
    no chunk step is built). Per decode call 896 joint, 32 row_attention
    and 65 row_norm launches from the device records; compiled == eager
    bitwise on 2 short requests, whose first-token logits agree with the
    plain path; a profiled decode window. Returns the device launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch import obs
    from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
    args = serve.build_parser().parse_args(MOE_SERVE_ARGS)
    cfg = get_config(args.arch, dbpim_mode=args.dbpim_mode)
    engine, trace, tables = _moe_build(args, cfg, dev)
    assert engine.prefill_mode == "full" and engine._prefill is None
    assert engine.cache["attn"]["k"].shape[2] == min(args.max_len,
                                                     cfg.window)

    def make(graphs=True):
        return ServeEngine(cfg, engine.params, n_slots=args.batch,
                           max_len=args.max_len, stacked_tables=tables,
                           device=dev, cuda_graphs=graphs)
    engine, outputs, device, counts, peak = _counted_run(engine, trace, make)
    wf = check_waterfall(engine, tables, "moe")["decode"]
    per_call = obs.per_call(cfg)
    s = engine.metrics.summary()
    calls = s["device_calls"]
    assert per_call == {"joint_sparse_matmul": 896, "row_attention": 32,
                        "row_norm": 65}, per_call
    assert s["n_completed"] == len(trace) == 8 and s["prefill_calls"] == 0
    assert all(len(outputs[r.rid]) == r.gen_len for r in trace)
    assert counts == {name: per_call.get(name, 0) for name in counts}, counts
    from repro_torch.obs import RecompileSentinel
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(k, cfg.name): 1 for k in ("decode", "reset")}
    lat = s["call_latency_ms"]["decode"]
    log(f"[moe] {cfg.name} compiled serve (under torch.profiler): "
        f"{s['n_completed']}/{s['n_requests']} requests, "
        f"{s['generated_tokens']} tokens, {calls} decode calls (prompts "
        f"stepwise: prefill mode full), {s['tokens_per_sec']:.1f} tokens/s "
        f"over {s['wall_s']:.2f} s; decode ms/call p50={lat['p50_ms']:.2f} "
        f"mean={lat['mean_ms']:.2f}; device launches "
        + ", ".join(f"{name} {device[name]} == {n} x {calls}"
                    for name, n in per_call.items())
        + f" (the port's other kernels: 0); host-counted: the first decode "
        f"call's warm-up {counts['joint_sparse_matmul']}; sentinel "
        + ", ".join(f"{k}={n}" for k, n in engine.sentinel.counts().items())
        + f"; peak device memory {peak:.3f} GiB")
    # compiled == eager, and the kernel path against the plain one, on 2
    # short requests
    short = make_trace(WorkloadSpec(**MOE_SHORT), cfg.vocab_size)
    runs = {}
    for graphs in (True, False):
        e = make(graphs)
        runs[graphs] = (e, e.run(short))
        torch.cuda.synchronize()
    (comp, out_c), (eag, out_e) = runs[True], runs[False]
    _same_runs(comp, out_c, eag, out_e, short, ("decode", "reset"))
    log(f"[moe] {cfg.name}, 2 requests (prompts "
        f"{[r.prompt_len for r in short]}): compiled == eager, streams and "
        f"first-token logits bitwise; eager decode p50 "
        f"{eag.metrics.summary()['call_latency_ms']['decode']['p50_ms']:.1f}"
        f" ms")
    for r in short:
        with plain_versions():
            ref = _stepwise_run(engine, tables, list(r.prompt))[0]
        d, tol = _logit_gap(comp.first_logits[r.rid][0], ref)
        assert d <= tol, (r.rid, d, tol)
        log(f"[moe] {cfg.name} request {r.rid}: first-token logits (1, V) "
            f"bf16, kernel path vs the plain path (stepwise, batch 1) "
            f"max|d|={d:.3e} (tol {tol:.3e} = {LOGIT_REL_TOL} x max|ref|)")
    del runs, comp, eag, e
    prof = phase_profile([("mixtral compiled", engine)])
    packs, unembed, routers = _hand_terms(wf, tables, cfg)
    bound_ms = 1e3 * wf["total"] / HBM_BYTES_PER_S
    wall, busy = prof[("mixtral compiled", "decode call")][:2]
    log(f"[moe] {cfg.name} compiled decode call: {wall:.3f} ms wall, "
        f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}; "
        f"bytes bound {bound_ms:.3f} ms (the decode waterfall's "
        f"{wf['total'] / 1e9:.4f} GB at 3.35 TB/s: packs read "
        f"{packs / 1e9:.4f} GB + unembedding {unembed / 1e9:.4f} GB + "
        f"routers {routers / 1e9:.4f} GB, the first two the hand sum's)")
    return {name: device[name] for name in per_call}


def phase_ring(dev):
    """The ring on the card: reduced mixtral (window 32) at max-len 96,
    through the compiled engine and an eager one on requests of 70..90
    positions (every ring wraps more than once): streams and first-token
    logits bitwise equal; then request 0's prompt and stream through
    stepwise decode, kernel path against plain, the last step's logits
    (past two wraps) within LOGIT_REL_TOL of the plain path's peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serving import ServeEngine
    args = serve.build_parser().parse_args(RING_ARGS)
    cfg = get_config(args.arch, reduced=True, dbpim_mode=args.dbpim_mode)
    engine, trace, tables = serve.build_engine_and_trace(args, cfg)
    eager = ServeEngine(cfg, engine.params, n_slots=args.batch,
                        max_len=args.max_len, stacked_tables=tables,
                        device=dev, cuda_graphs=False)
    out_c, out_e = engine.run(trace), eager.run(trace)
    torch.cuda.synchronize()
    A = engine.cache["attn"]["k"].shape[2]
    assert A == cfg.window == 32 and engine.prefill_mode == "full"
    assert min(r.prompt_len + r.gen_len for r in trace) > 2 * A
    _same_runs(engine, out_c, eager, out_e, trace, ("decode", "reset"))
    r = trace[0]
    seq = list(r.prompt) + out_c[r.rid][:-1]
    got = _stepwise_run(engine, tables, seq)[0]
    with plain_versions():
        ref = _stepwise_run(engine, tables, seq)[0]
    d, tol = _logit_gap(got, ref)
    assert d <= tol, (d, tol)
    log(f"[moe] ring ({cfg.name}, window {cfg.window}, max-len "
        f"{args.max_len}: {A} rows): {len(trace)} requests of "
        f"{[r.prompt_len + r.gen_len for r in trace]} positions, compiled "
        f"== eager bitwise (streams, first-token logits); request 0's "
        f"{len(seq)} positions stepwise, the last logits kernel vs plain "
        f"max|d|={d:.3e} (tol {tol:.3e}); reduced width and depth: at full "
        f"width a wrap takes over 4,096 decode calls")


def phase_arctic(dev):
    """arctic-480b at full width, cut to ARCTIC_LAYERS of its 35 layers
    (the dense residual MLP beside 128 experts), built slice by slice,
    served on 2 requests with chunked prefill (per-position dispatch):
    per call 782 joint launches from the device records, compiled ==
    eager bitwise, first-token logits against the plain path, and a
    chunk equal to stepwise decode op by op, bitwise (the router's
    rows included). Returns the device launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch import obs
    from repro_torch.serving import ServeEngine
    args = serve.build_parser().parse_args(ARCTIC_ARGS)
    cfg = get_config(args.arch, dbpim_mode=args.dbpim_mode).scaled(
        n_layers=ARCTIC_LAYERS)
    engine, trace, tables = _moe_build(args, cfg, dev)

    def make(graphs=True):
        return ServeEngine(cfg, engine.params, n_slots=args.batch,
                           max_len=args.max_len,
                           prefill_chunk=args.prefill_chunk,
                           stacked_tables=tables, device=dev,
                           cuda_graphs=graphs)
    eager = make(False)
    reset_launches()
    out_e = eager.run(trace)
    torch.cuda.synchronize()
    eager_counts = read_launches()
    engine, out_c, device, counts, peak = _counted_run(engine, trace, make)
    check_waterfall(engine, tables, "moe")
    per_call = obs.per_call(cfg)
    calls = engine.metrics.summary()["device_calls"]
    assert per_call == {"joint_sparse_matmul": 782, "row_attention": 2,
                        "row_norm": 5}, per_call
    assert eager_counts == {name: per_call.get(name, 0) * calls
                            for name in eager_counts}, eager_counts
    kinds = ("decode", "prefill_chunk_exact", "reset")
    _same_runs(engine, out_c, eager, out_e, trace, kinds)
    s = engine.metrics.summary()
    log(f"[moe] {cfg.name} ({cfg.n_layers} of 35 layers) compiled engine, "
        f"{len(trace)} requests (prompts {[r.prompt_len for r in trace]}), "
        f"chunks of {args.prefill_chunk}: {s['decode_calls']} decode + "
        f"{s['prefill_calls']} prefill calls, compiled == eager bitwise; "
        f"device launches "
        + ", ".join(f"{name} {device[name]} == {n} x {calls}"
                    for name, n in per_call.items())
        + f"; decode p50 {s['call_latency_ms']['decode']['p50_ms']:.2f} ms, "
        f"prefill_chunk_exact p50 "
        f"{s['call_latency_ms']['prefill_chunk_exact']['p50_ms']:.2f} ms; "
        f"peak {peak:.3f} GiB")
    for r in trace:
        with plain_versions():
            ref = _chunked_run(engine, tables, list(r.prompt),
                               engine.prefill_chunk)[0]
        d, tol = _logit_gap(engine.first_logits[r.rid][0], ref)
        assert d <= tol, (r.rid, d, tol)
        log(f"[moe] {cfg.name} request {r.rid}: first-token logits, kernel "
            f"vs plain max|d|={d:.3e} (tol {tol:.3e})")
    check_chunk_equals_stepwise(engine, tables, list(trace[0].prompt))
    return {name: device[name] for name in per_call}


def _encoder_attention_inputs(cfg, dev, dtype, gen, Sq, B=4):
    """Non-causal attention at whisper's shapes: B slots' ``cfg.encoder_seq``
    keys (the encoder's frames, or the encoder output cross-attention
    reads), Sq queries a slot, every query at the last key (the
    reference's all-ones mask)."""
    A, H, hd = cfg.encoder_seq, cfg.n_heads, cfg.hd
    k = torch.randn((B, A, cfg.n_kv_heads, hd), generator=gen).to(dtype)
    v = torch.randn((B, A, cfg.n_kv_heads, hd), generator=gen).to(dtype)
    q = torch.randn((B, Sq, H, hd), generator=gen).to(dtype)
    pos = torch.full((B, Sq), A - 1, dtype=torch.int32)
    return q.to(dev), k.to(dev), v.to(dev), pos.to(dev)


def phase_seg_kernel_rows(jamba_cfg, whisper_cfg, dense_cfgs, dev):
    """row_attention at the segmented and dense phases' shapes against
    its plain version (f32 within 1e-5 x max|ref|, bf16 within 2^-6 x
    max|ref|): non-causal, every query at the last of 1,500 keys, hd 64,
    group 1 (the whisper encoder's 4 x 1,500 queries; cross-attention's 1
    and 64 queries a slot); causal, whisper's decoder self-attention (hd
    64, group 1) against its 448-slot cache, and jamba's (hd 128, group
    4) and each of ``dense_cfgs``' (qwen3 hd 128, group 4; gemma hd 256,
    group 1; stablelm hd 64, group 1) against a 512-slot cache, each a
    decode call and a 64-query chunk. A query alone comes out bitwise
    equal to the same query in the call. Returns the worst bf16 error.
    (row_norm's new widths, 512 with LayerNorm, jamba's gated 8192,
    gemma's 3,072 and qwen3's qk-norm over rows of 128, run in
    phase_kernel_rows.)"""
    from repro_torch.kernels import row_attention as rak
    gen = torch.Generator().manual_seed(10)
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        cases = [(f"whisper {what}",) + _encoder_attention_inputs(
                    whisper_cfg, dev, dt, gen, Sq)
                 for what, Sq in (("encoder", whisper_cfg.encoder_seq),
                                  ("cross decode", 1), ("cross chunk", 64))]
        for name, c, A in (("whisper self", whisper_cfg, WHISPER_MAX_LEN),
                           ("jamba", jamba_cfg, 512),
                           *((c.name, c, 512) for c in dense_cfgs)):
            a = _serve_attention_inputs(c, dev, dt, gen, A=A)
            cases += [(f"{name} {what}", a[what][0], a["k"], a["v"],
                       a[what][1]) for what in ("decode", "chunk")]
        for what, q, k, v, pos in cases:
            y = rak.row_attention(q, k, v, pos)
            torch.cuda.synchronize()
            ref = rak.row_attention_plain(q, k, v, pos)
            peak = ref.float().abs().max().item()
            err = (y.float() - ref.float()).abs().max().item()
            tol = (F32_TOL if dt == torch.float32 else ATTN_REL_TOL) * peak
            assert torch.isfinite(y).all() and err <= tol, \
                ("row_attention", what, dt, err, tol)
            if dt == torch.bfloat16:
                worst = max(worst, err)
            ts = sorted({0, q.shape[1] // 2, q.shape[1] - 1})
            for t in ts:
                one = rak.row_attention(q[:, t:t + 1].contiguous(), k, v,
                                        pos[:, t:t + 1].contiguous())
                assert torch.equal(one, y[:, t:t + 1]), (what, dt, t)
            log(f"[seg] row_attention {what} {tuple(q.shape)} x "
                f"{tuple(k.shape)} {str(dt)[6:]}: max|d|={err:.3e} (tol "
                f"{tol:.3e}); queries {ts} bitwise equal to one-query calls")
            del y, ref
    return worst


def phase_seg_pack(jamba_cfg, dev):
    """jamba's expert slices as the slice-by-slice build packs them
    (``pack_joint_sparse_balanced`` at the shape's balanced MAXB), made on
    the card, byte-identical to the CPU's: w_gate / w_up and w_down."""
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(11)
    vs = jamba_cfg.dbpim_value_sparsity
    d, f = jamba_cfg.d_model, jamba_cfg.d_ff
    for name, K, N in (("moe/w_up", d, f), ("moe/w_down", f, d)):
        w = (torch.randn((K, N), generator=gen) * K ** -0.5).to(
            torch.bfloat16)
        kw = dict(bk=128, bn=128, value_sparsity=vs, payload="int8")
        maxb = ops.balanced_maxb(K, vs, 128)
        card = ops.pack_joint_sparse_balanced(w.to(dev), maxb, **kw)
        cpu = ops.pack_joint_sparse_balanced(w, maxb, **kw)
        for field in ("w_blocks", "idx", "scales", "nblocks"):
            a, b = getattr(card, field).cpu(), getattr(cpu, field)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
        log(f"[seg] {jamba_cfg.name} expert slice {name} {K}x{N}, packed as "
            f"the slice-by-slice build packs it (MAXB {maxb}): card pack == "
            f"cpu pack byte for byte")


def _gaps(got, ref):
    """A chunk form's run against stepwise decode's (each a
    ``_chunked_run`` / ``_stepwise_run`` result): the first-token logits'
    max|d| and peak, the layers' output (``_stack_out``) max|d| and
    peak, and the worst SSM state's max|d| relative to its own peak."""
    (lg, cg, sg), (lr, cr, sr) = got, ref
    states = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
              for path, b in _flat(cr).items() if path.endswith("/state")
              for a in [_flat(cg)[path]]]
    return {"logit_d": (lg - lr).abs().max().item(),
            "logit_peak": lr.abs().max().item(),
            "stack_d": (sg - sr).abs().max().item(),
            "stack_peak": sr.abs().max().item(),
            "state_rel_d": max(states)}


def phase_jamba(dev):
    """jamba-v0.1-52b at full width and depth (32 layers: 28 SSM, 4
    attention, 16 MoE of 16 experts, 16 dense MLP) in joint mode, built
    slice by slice on the card (its 90 GB of dense experts never exist;
    the build's peak under packs + non-expert dense weights + one layer's
    dense expert stacks), served on phase 4's trace by the compiled
    engine with parallel SSD chunks of 64: per call 888 joint, 4
    row_attention and 93 row_norm launches from the device records;
    compiled == eager bitwise on 2 short requests; exact chunks (batch 1,
    40 tokens in chunks of 16) bitwise equal to stepwise decode op by op,
    and every cache leaf; a profiled compiled decode and prefill window
    beside the decode call's bytes bound. In bf16 the kernel path's
    first-token logits are held to the plain path's with the plain path's
    top-2 choices replayed into it (``_routing``): each side's own rounding
    flips near-tied choices. The kernel path against the plain path with
    its own routing, and the parallel chunks against stepwise decode, are
    held in a float32 copy of its first JAMBA_F32_LAYERS layers
    (``_jamba_f32``, see there).
    Returns the device launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch import obs
    from repro_torch.obs import RecompileSentinel
    from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
    args = serve.build_parser().parse_args(JAMBA_SERVE_ARGS)
    cfg = get_config(args.arch, dbpim_mode=args.dbpim_mode)
    engine, trace, tables = _moe_build(args, cfg, dev, tag="seg")
    kinds = ("decode", "prefill_parallel", "reset")
    assert engine.prefill_kind == "prefill_parallel"
    assert len(tables.segments) == cfg.n_layers

    def make(graphs=True):
        return ServeEngine(cfg, engine.params, n_slots=args.batch,
                           max_len=args.max_len,
                           prefill_chunk=args.prefill_chunk,
                           stacked_tables=tables, device=dev,
                           cuda_graphs=graphs)
    engine, outputs, device, counts, peak = _counted_run(engine, trace, make)
    wf = check_waterfall(engine, tables, "seg")["decode"]
    per_call = obs.per_call(cfg)
    assert per_call == JAMBA_PER_CALL, per_call
    s = engine.metrics.summary()
    calls = s["device_calls"]
    assert s["n_completed"] == len(trace) == args.requests
    assert all(len(outputs[r.rid]) == r.gen_len for r in trace)
    assert counts == {name: 2 * per_call.get(name, 0) for name in counts}, \
        counts
    assert engine.sentinel.counts() == {
        RecompileSentinel.key(k, cfg.name): 1 for k in kinds}
    lat = s["call_latency_ms"]
    log(f"[seg] {cfg.name} compiled serve (under torch.profiler): "
        f"{s['n_completed']}/{s['n_requests']} requests, "
        f"{s['generated_tokens']} tokens, {s['decode_calls']} decode + "
        f"{s['prefill_calls']} prefill_parallel calls, "
        f"{s['tokens_per_sec']:.1f} tokens/s over {s['wall_s']:.2f} s; "
        f"decode ms/call p50={lat['decode']['p50_ms']:.2f} "
        f"mean={lat['decode']['mean_ms']:.2f}; prefill_parallel p50="
        f"{lat['prefill_parallel']['p50_ms']:.2f} ms; device launches "
        + ", ".join(f"{name} {device[name]} == {n} x {calls}"
                    for name, n in per_call.items())
        + f" (the port's other kernels: 0); sentinel "
        + ", ".join(f"{k}={n}" for k, n in engine.sentinel.counts().items())
        + f"; peak device memory {peak:.3f} GiB")
    # compiled == eager on 2 short requests (one chunk each)
    short = make_trace(WorkloadSpec(**MOE_SHORT), cfg.vocab_size)
    runs = {}
    for graphs in (True, False):
        e = make(graphs)
        runs[graphs] = (e, e.run(short))
        torch.cuda.synchronize()
    (comp, out_c), (eag, out_e) = runs[True], runs[False]
    _same_runs(comp, out_c, eag, out_e, short, kinds)
    log(f"[seg] {cfg.name}, 2 requests (prompts "
        f"{[r.prompt_len for r in short]}): compiled == eager, streams and "
        f"first-token logits bitwise, one signature per step")
    first = {r.rid: comp.first_logits[r.rid][0] for r in short}
    del runs, comp, eag, e
    # exact chunks: bitwise stepwise decode, op by op through every segment
    gen = torch.Generator().manual_seed(12)
    prompt = torch.randint(1, cfg.vocab_size, (JAMBA_PROMPT,),
                           generator=gen).tolist()
    check_chunk_equals_stepwise(engine, tables, prompt,
                                cfg.scaled(prefill_exact=True), JAMBA_CHUNK,
                                tag="seg")
    # bf16: the kernel path against the plain path with the plain path's
    # top-2 choices replayed into it (each side's own rounding flips
    # near-tied choices, a flipped slot reading another expert), held to
    # LOGIT_REL_TOL; beside it the engine's own first-token logits and the
    # plain path against itself in another order (its parallel chunks
    # against its stepwise decode), measured
    for r in short:
        p = list(r.prompt)
        with plain_versions(), _routing() as plain:
            ref = _chunked_run(engine, tables, p, args.prefill_chunk)[0]
        with plain_versions():
            own = _stepwise_run(engine, tables, p)[0]
        with _routing(plain["idx"]) as replayed:
            got = _chunked_run(engine, tables, p, args.prefill_chunk)[0]
        d, tol = _logit_gap(got, ref)
        d_own, _ = _logit_gap(first[r.rid], ref)
        log(f"[seg] {cfg.name} bf16 request {r.rid}: first-token logits, "
            f"kernel vs plain path with the plain path's routing replayed "
            f"({len(plain['idx'])} routing calls, {replayed['flips']} "
            f"tokens whose own top-2 differed) max|d|={d:.3e} (tol "
            f"{tol:.3e} = {LOGIT_REL_TOL} x max|ref|); measured beside it: "
            f"the engine's own routing {d_own:.3e}, the plain path's chunk "
            f"vs its own stepwise decode {(ref - own).abs().max().item():.3e}")
        assert d <= tol, (r.rid, d, tol)
    g = _gaps(_chunked_run(engine, tables, prompt, JAMBA_CHUNK),
              _stepwise_run(engine, tables, prompt))
    log(f"[seg] {cfg.name} bf16: parallel chunks vs stepwise decode "
        f"({JAMBA_PROMPT} tokens in chunks of {JAMBA_CHUNK}): first-token "
        f"logits max|d|={g['logit_d']:.3e} of max|ref| "
        f"{g['logit_peak']:.3f}; the layers' output max|d|="
        f"{g['stack_d']:.3e} of {g['stack_peak']:.3f}; states max|d| "
        f"{g['state_rel_d']:.3e} of their layer's peak (measured, not a "
        f"bound: held in float32 below)")
    prof = phase_profile([("jamba compiled", engine)])
    packs, unembed, routers = _hand_terms(wf, tables, cfg)
    # the walker charges weights only: the SSM states stay a term apart
    state = 2 * sum(v.numel() * v.element_size()
                    for path, v in _flat(engine.cache).items()
                    if path.endswith("/state"))
    experts = _nbytes({k: {p: a for p, a in v.items() if p != "nblocks"}
                       for k, v in tables.arrays.items() if "moe/" in k})
    bound_ms = 1e3 * (wf["total"] + state) / HBM_BYTES_PER_S
    wall, busy = prof[("jamba compiled", "decode call")][:2]
    log(f"[seg] {cfg.name} compiled decode call: {wall:.3f} ms wall, busy "
        f"{'not measured' if busy is None else f'{busy:.3f} ms'}; bytes "
        f"bound {bound_ms:.3f} ms (the decode waterfall's "
        f"{wf['total'] / 1e9:.4f} GB: packs read {packs / 1e9:.4f} GB, of "
        f"which experts {experts / 1e9:.4f}; unembedding "
        f"{unembed / 1e9:.4f} GB; routers {routers / 1e9:.6f} GB; beside "
        f"it the SSM states read and written {state / 1e9:.3f} GB; at "
        f"3.35 TB/s)")
    launches = {name: device[name] for name in per_call}
    del engine, tables, prof
    torch.cuda.empty_cache()
    _jamba_f32(args, cfg, short, prompt, dev)
    return launches


def _jamba_f32(args, cfg, short, prompt, dev):
    """jamba in float32 at full width and JAMBA_F32_LAYERS deep (built
    slice by slice;
    int8 packs as in bf16, f32 activations through the joint kernel's fp32
    path): the first-token logits of the 2 short requests, kernel path vs
    plain path, within JAMBA_F32_REL x max|ref|; parallel chunks vs
    stepwise decode (the 40-token prompt in chunks of 16) within the
    reference's PARALLEL_PREFILL_ATOL["float32"] x max(|ref|, 1) on the
    logits, x its peak on the layers' output, and of each layer's peak on
    the states. In bf16 neither bound can separate a fault from rounding
    at this depth: the two sides' roundings flip near-tied top-2 routing
    choices (a flipped slot reads another expert), and the plain path
    disagrees with itself (chunk vs stepwise) by ~6 % of the logits'
    peak."""
    from repro_torch.models import ssm
    c32 = cfg.scaled(dtype="float32", n_layers=JAMBA_F32_LAYERS)
    e, _, t = _moe_build(args, c32, dev, tag="seg")
    worst = 0.0
    for r in short:
        p = list(r.prompt)
        got = _chunked_run(e, t, p, args.prefill_chunk)[0]
        with plain_versions():
            ref = _chunked_run(e, t, p, args.prefill_chunk)[0]
        d = (got - ref).abs().max().item()
        tol = JAMBA_F32_REL * ref.abs().max().item()
        worst = max(worst, d)
        log(f"[seg] {cfg.name} float32 request {r.rid}: first-token logits, "
            f"kernel vs plain path max|d|={d:.3e} (tol {tol:.3e} = "
            f"{JAMBA_F32_REL} x max|ref|)")
        assert d <= tol, (r.rid, d, tol)
    g = _gaps(_chunked_run(e, t, prompt, JAMBA_CHUNK),
              _stepwise_run(e, t, prompt))
    rel = ssm.PARALLEL_PREFILL_ATOL["float32"]
    tol, stack_tol = rel * max(g["logit_peak"], 1.0), rel * g["stack_peak"]
    log(f"[seg] {cfg.name} float32: parallel chunks vs stepwise decode "
        f"({JAMBA_PROMPT} tokens in chunks of {JAMBA_CHUNK}), first-token "
        f"logits max|d|={g['logit_d']:.3e} (tol {tol:.3e} = {rel} x "
        f"{g['logit_peak']:.3f}); the layers' output max|d|="
        f"{g['stack_d']:.3e} (tol {stack_tol:.3e}); states max|d| "
        f"{g['state_rel_d']:.3e} of their layer's peak (tol {rel})")
    assert g["logit_d"] <= tol and g["stack_d"] <= stack_tol, g
    assert g["state_rel_d"] <= rel, g
    del e, t
    torch.cuda.empty_cache()


def phase_whisper(dev):
    """whisper-base at full width (6 encoder + 6 decoder layers) in joint
    mode: the encoder once over 4 x 1,500 frames from a seed (6
    row_attention and 13 row_norm launches and no joint launch from the
    device records; its output within LOGIT_REL_TOL x max|ref| of the
    plain path), then phase_serve's checks on phase 4's trace at max-len
    448 (60 joint, 12 row_attention and 19 row_norm launches a call;
    compiled == eager bitwise; first-token logits against the plain path;
    a chunk equal to stepwise decode op by op, cross-attention included),
    and a profiled decode and prefill window. Returns the device launches,
    the encoder's included."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.launch import serve
    from repro_torch.models import encode
    from repro_torch.models.inputs import stub_frames
    from repro_torch.obs import device_launches
    launches, engine, eager, tables = phase_serve(
        dev, WHISPER_SERVE_ARGS, "prefill_chunk_exact", tag="seg")
    cfg = engine.cfg
    assert obs.per_call(cfg) == WHISPER_PER_CALL
    del eager
    seed = serve.build_parser().parse_args(WHISPER_SERVE_ARGS).seed
    frames = stub_frames(cfg, engine.n_slots, seed, dev)
    recorded = {name: mod for name, mod in _kernel_modules().items()
                if name != "block_sparse_matmul"}
    want = obs.encoder_per_call(cfg)
    assert want == WHISPER_ENCODER_PER_CALL, want
    for attempt in range(3):
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _pad()
            enc = encode(engine.params, frames, cfg)
            _pad()
        device = device_launches(prof, recorded)
        if all(device[k] == want.get(k, 0) for k in device):
            break
        log(f"[seg] encoder run {attempt + 1}: the profiler's device records "
            f"count {device}, not {want}; taken again")
    else:
        raise AssertionError(f"encoder launches {device} != {want}")
    counts = read_launches()
    assert all(counts[k] == want.get(k, 0) for k in device), counts
    assert torch.equal(enc, engine.cache["enc_out"])
    t0 = time.monotonic()
    encode(engine.params, frames, cfg)
    torch.cuda.synchronize()
    enc_ms = 1e3 * (time.monotonic() - t0)
    with plain_versions():
        ref = encode(engine.params, frames, cfg).float()
    d, tol = _logit_gap(enc, ref)
    assert enc.shape == frames.shape and d <= tol, (d, tol)
    log(f"[seg] {cfg.name} encoder over {tuple(frames.shape)} frames: "
        f"device launches " + ", ".join(f"{k} {v}" for k, v in device.items())
        + f" (== {want}); {enc_ms:.2f} ms; the engine's enc_out is this "
        f"output bitwise; kernel vs plain path max|d|={d:.3e} (tol "
        f"{tol:.3e} = {LOGIT_REL_TOL} x max|ref|)")
    phase_profile([("whisper compiled", engine)])
    fwd = family_forward(engine, tables, "fwd")
    return {k: launches.get(k, 0) + device.get(k, 0) + fwd[k]
            for k in launches}


# ---------------------------------------------------------------------------
# The forward phase: the window bound, pixtral-12b, the windowed forward and
# the resident families' forward
# ---------------------------------------------------------------------------

def _window_inputs(cfg, dev, dtype, gen, B, A, Sq):
    """Sq queries per row at the end of a sequence of A keys (positions A
    - Sq .. A - 1), at ``cfg``'s head layout, and the sequence's keys."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.randn((B, Sq, H, hd), generator=gen).to(dtype).to(dev)
    k = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    v = torch.randn((B, A, Hkv, hd), generator=gen).to(dtype).to(dev)
    pos = (A - Sq + torch.arange(Sq, dtype=torch.int32)).expand(B, Sq)
    return q, k, v, pos.contiguous().to(dev)


def _nan_pattern(v, pos, window):
    """(B, Sq, Hkv, hd) bool: the outputs the reference makes NaN, its
    0 * v summed over every key of the cache: column d of query (b, s) at
    KV head h is NaN when a key outside the query's live range (pos -
    window, pos] has a non-finite v[b, key, h, d], or a live key a NaN one
    (a live Inf gives Inf)."""
    B, A = v.shape[:2]
    kpos = torch.arange(A, device=v.device)
    qp = pos[:, :, None].long()
    dead = kpos > qp
    if window:
        dead |= kpos <= qp - window
    hit = (torch.einsum("bsa,bahd->bshd", dead.float(),
                        (~torch.isfinite(v.float())).float())
           + torch.einsum("bsa,bahd->bshd", (~dead).float(),
                          torch.isnan(v.float()).float()))
    return hit > 0


def _plant_dead(k, v, pos, window, gen):
    """Copies of k and v with NaN, +Inf and -Inf planted at random columns
    of V rows dead to every query of their batch row (past the last
    query's position, below the first query's window: in key tiles a
    kernel block multiplies and in tiles it skips), NaN in the V row of
    the last query's position (live to it alone), and NaN in whole dead K
    rows."""
    B, A, Hkv, hd = v.shape
    kp, vp = k.clone(), v.clone()
    vals = (float("nan"), float("inf"), float("-inf"))
    for b in range(B):
        top = int(pos[b].max())
        rows = [r for r in (top + 1, top + 2, top + 70, A - 1) if r < A]
        if window:
            bottom = int(pos[b].min()) - window
            rows += [r for r in (0, bottom // 2, bottom) if 0 <= r <= bottom]
        for i, r in enumerate(rows + [top]):
            h = int(torch.randint(Hkv, (1,), generator=gen))
            for c in torch.randperm(hd, generator=gen)[:3].tolist():
                vp[b, r, h, c] = vals[i % 3] if r != top else float("nan")
            if r != top:
                kp[b, r, (h + 1) % Hkv, :] = float("nan")
    return kp, vp


def _check_dead_keys(rak, q, k, v, pos, window, gen, what, dt):
    """The reference's reading of dead keys, at query positions A / 8 below
    ``pos`` (so that keys past every query exist): with non-finite values
    planted in dead V rows and NaN in dead K rows (``_plant_dead``), the
    kernel's NaN outputs are exactly ``_nan_pattern``'s and the plain
    version's, and every other output is bitwise the clean call's. Returns
    the number of NaN outputs the plant made."""
    pos = (pos - k.shape[1] // 8).clamp(min=0).contiguous()
    clean = rak.row_attention(q, k, v, pos, window)
    kp, vp = _plant_dead(k, v, pos, window, gen)
    got = rak.row_attention(q, kp, vp, pos, window)
    torch.cuda.synchronize()
    G = q.shape[2] // k.shape[2]
    want = torch.repeat_interleave(_nan_pattern(vp, pos, window), G, dim=2)
    plain = torch.isnan(rak.row_attention_plain(q, kp, vp, pos, window))
    nan = torch.isnan(got)
    assert want.any() and torch.equal(plain, want), \
        ("dead keys: plain version", what, dt, window,
         int((plain != want).sum()))
    assert torch.equal(nan, want), \
        ("dead keys: NaN pattern", what, dt, window,
         int((nan & ~want).sum()), int((want & ~nan).sum()))
    assert torch.equal(got[~nan], clean[~nan]), \
        ("dead keys: finite outputs moved", what, dt, window)
    return int(want.sum())


def phase_kernel_window(cfg, dev):
    """row_attention's lower key bound (keys at or below qpos - window are
    dead) in all four of its kernels, at ``cfg``'s head layout (pixtral's
    and mixtral's: 32 / 8 heads of 128): bf16 and f32 resident at 2 x 512
    causal queries over their own 512 keys, window 64; bf16 streaming at
    64 queries at the end of 32,768 keys and f32 streaming at the end of
    65,536, window 4,096. Each within its tolerance of the plain version
    at the same window; window 0 bitwise equal to the call without one;
    a query alone bitwise equal to the same query in the call (every one
    of the 512). The reference's reading of dead keys at windows w and 0
    (``_check_dead_keys``): NaN and Inf planted in V rows past every query
    and below every query's window, NaN in dead K rows; the NaN outputs
    equal the plain version's, every other output is bitwise the clean
    call's; also in the resident bf16 kernel with its keys split over a
    cluster (2,048 keys). Returns the worst bf16 error."""
    from repro_torch.kernels import row_attention as rak
    gen = torch.Generator().manual_seed(20)
    worst = 0.0
    for dt in (torch.bfloat16, torch.float32):
        A_stream = STREAM_A_BF16 if dt == torch.bfloat16 else STREAM_A_F32
        for what, B, A, Sq, window in (
                ("resident", 2, WINDOW_S, WINDOW_S, WINDOW_RESIDENT),
                ("streaming", 1, A_stream, STREAM_C, WINDOW_STREAM)):
            assert rak.streams(A, cfg.hd, dt) == (what == "streaming")
            q, k, v, pos = _window_inputs(cfg, dev, dt, gen, B, A, Sq)
            y = rak.row_attention(q, k, v, pos, window)
            torch.cuda.synchronize()
            ref = rak.row_attention_plain(q, k, v, pos, window)
            peak = ref.float().abs().max().item()
            err = (y.float() - ref.float()).abs().max().item()
            tol = (F32_TOL if dt == torch.float32 else ATTN_REL_TOL) * peak
            assert torch.isfinite(y).all() and err <= tol, \
                ("row_attention window", what, dt, err, tol)
            if dt == torch.bfloat16:
                worst = max(worst, err)
            del ref
            y0 = rak.row_attention(q, k, v, pos)
            assert torch.equal(rak.row_attention(q, k, v, pos, 0), y0), \
                ("window 0", what, dt)
            planted = [_check_dead_keys(rak, q, k, v, pos, w, gen, what, dt)
                       for w in (window, 0)]
            log(f"[fwd] row_attention {what} {str(dt)[6:]}: NaN and Inf in "
                f"dead V rows, NaN in dead K rows, windows {window} and 0: "
                f"the NaN outputs ({planted[0]}, {planted[1]}) are the "
                f"reference's 0 * v, every other output bitwise the clean "
                f"call's")
            del y0
            for t in range(Sq):
                one = rak.row_attention(q[:, t:t + 1].contiguous(), k, v,
                                        pos[:, t:t + 1].contiguous(), window)
                assert torch.equal(one, y[:, t:t + 1]), \
                    ("window rows", what, dt, t)
            log(f"[fwd] row_attention {what} {str(dt)[6:]}, window "
                f"{window}: {tuple(q.shape)} queries at the end of "
                f"{tuple(k.shape)} keys, max|d|={err:.3e} vs the plain "
                f"version at the same window (tol {tol:.3e}); window 0 "
                f"bitwise the call without one; all {Sq} queries alone "
                f"bitwise equal to the same queries in the {Sq}-query call")
            del q, k, v, y
    # the resident bf16 kernel with its keys split over a cluster (4 ranks
    # at 2,048 keys): the ranks' column masks meet through distributed
    # shared memory
    q, k, v, pos = _window_inputs(cfg, dev, torch.bfloat16, gen, 2, LONG_A,
                                  STREAM_C)
    planted = [_check_dead_keys(rak, q, k, v, pos, w, gen, "resident split",
                                torch.bfloat16) for w in (256, 0)]
    log(f"[fwd] row_attention resident bf16, keys split over a cluster: "
        f"{tuple(q.shape)} queries, {tuple(k.shape)} keys, windows 256 and "
        f"0: the NaN outputs ({planted[0]}, {planted[1]}) are the "
        f"reference's 0 * v, every other output bitwise the clean call's")
    return worst


@contextlib.contextmanager
def _forward_final_norm_inputs(params):
    """Records the input of ``transformer.forward``'s final norm (the
    residual stream after the last layer) into the list it yields."""
    from repro_torch.models import transformer
    rows, norm = [], transformer.apply_norm

    def f(p, x, cfg):
        if p is params["final_norm"]:
            rows.append(x)
        return norm(p, x, cfg)
    transformer.apply_norm = f
    try:
        yield rows
    finally:
        transformer.apply_norm = norm


def _counted_forward(fn, want, tag, what):
    """``fn()`` (one forward call) under torch.profiler: its launches from
    the device records must be ``want`` of each kernel (the port's others
    0) and equal the wrappers' host counts (eager: every launch is a host
    launch). Up to 3 windows (the profiler now and then loses records).
    Returns (fn's result, the launches)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import device_launches
    recorded = {name: mod for name, mod in _kernel_modules().items()
                if name != "block_sparse_matmul"}
    for attempt in range(3):
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _pad()
            out = fn()
            _pad()
        device = device_launches(prof, recorded)
        if all(device[k] == want.get(k, 0) for k in device):
            break
        log(f"[{tag}] {what} run {attempt + 1}: the profiler's device "
            f"records count {device}, not {want}; taken again")
    else:
        raise AssertionError(f"{what} launches {device} != {want}")
    counts = read_launches()
    assert all(counts[k] == want.get(k, 0) for k in counts), counts
    return out, device


class _CpuTwin:
    """The reduced tinyllama-1.1b engine on the CPU (float32, plain
    matmuls, phase 4g's geometry) over a trace's lengths and ticks, its
    token ids folded into the reduced vocabulary: the schedule (admission,
    first token, done, shed, faults landed) depends on lengths and ticks
    only, and its plain attention reads every key, as the reference's
    does."""

    def __init__(self):
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        self.cfg = get_config("tinyllama-1.1b", reduced=True).scaled(
            dtype="float32")
        self.params = init_params(self.cfg, device="cpu")

    def run(self, trace, plan=None, tracer=None, **kw):
        from repro_torch.serving import Request, ServeEngine
        V = self.cfg.vocab_size
        folded = [Request(r.rid, tuple(t % V for t in r.prompt), r.gen_len,
                          r.arrival, r.deadline) for r in trace]
        engine = ServeEngine(self.cfg, self.params, **{**ADMIT_GEOMETRY,
                                                       **kw},
                             fault_plan=plan, tracer=tracer, device="cpu")
        engine.run(folded)
        return engine


def _schedule(engine):
    """Per request (admitted, first token, done ticks, skips, faults,
    replays, outcome and reason) and the slot audit log."""
    return (engine.metrics.per_request(),
            [(iv.slot, iv.rid, iv.admit_tick, iv.release_tick)
             for iv in engine.slot_log])


def _quarantines(records):
    return [(r["tick"], r["attrs"]["slot"], r["attrs"]["kind"])
            for r in records if r.get("name") == "quarantine"]


def _fault_audit(plan, records, max_step_retries):
    """The faults a traced run should have counted, from its plan and the
    trace's schedule: every step exception the plan raised into a call the
    run issued (each call span's failed attempts, plus one fault a
    quarantined participant of a call whose retries ran out); every cache
    corruption aimed at a slot occupied when its tick began; every
    NaN-logits event aimed at a participant of a call that returned. A
    quarantine for non-finite logits that no such event explains must
    follow a landed corruption of its slot with no reset of the slot
    between (detection by propagation); any other is "unexplained": a NaN
    the plan did not put there. Returns the counts by kind, the NaN-logits
    events landed, the landed corruptions by fate ("detected"; "superseded"
    when a quarantine for another reason reset the slot first; "unread"
    when the slot was freed or taken by another request first), and the
    unexplained quarantines (tick, slot)."""
    counts = {"step_exception": 0, "cache_corruption": 0,
              "nonfinite_logits": 0}
    occupied, poisoned, nan, call = set(), set(), set(), None
    fate = {"detected": 0, "superseded": 0, "unread": 0}
    unexplained = []

    def clear(s, how):
        if s in poisoned:
            poisoned.discard(s)
            fate[how] += 1
    for r in records:
        name, a = r.get("name"), r.get("attrs", {})
        if r.get("type") == "span" and name == "tick":
            for s in plan.cache_slots(r["tick"]):
                if s in occupied:
                    counts["cache_corruption"] += 1
                    poisoned.add(s)
        elif r.get("type") == "span" and name == "call":
            call = r
            reps = [e.repeat for e in plan.events
                    if e.kind == "step_exception" and e.tick == r["tick"]
                    and e.call in ("any", a["phase"])]
            counts["step_exception"] += min(max(reps, default=0),
                                            max_step_retries + 1)
            if not a["ok"]:
                counts["step_exception"] += len(a["participants"])
                continue
            for s in set(plan.logit_slots(r["tick"], a["phase"])):
                if s in a["participants"]:
                    nan.add((r["tick"], a["phase"], s))
        elif name == "admit":
            occupied.add(a["slot"])
            clear(a["slot"], "unread")
        elif name in ("release", "shed") and "slot" in a:
            occupied.discard(a["slot"])
            clear(a["slot"], "unread")
        elif name == "quarantine":
            s = a["slot"]
            explained = (a["kind"] != "nonfinite_logits" or (
                call["tick"], call["attrs"]["phase"], s) in nan)
            counts["nonfinite_logits"] += a["kind"] == "nonfinite_logits"
            if not explained and s not in poisoned:
                unexplained.append((r["tick"], s))
            clear(s, "superseded" if explained else "detected")
    return {"counts": counts, "landed_nan": len(nan), **fate,
            "unexplained": unexplained}


def _streams_hold(outputs, engine, ref):
    """Each request's stream is its fault-free stream, or a prefix of it
    for a request shed after acceptance; returns the shed rids."""
    shed = []
    for rid, toks in outputs.items():
        row = engine.metrics.requests[rid]
        if row.outcome == "shed":
            assert toks == ref[rid][:len(toks)], rid
            shed.append(rid)
        else:
            assert row.outcome == "done" and toks == ref[rid], rid
    return shed


def phase_admission(engine, tables, ssm_engine, ssm_tables):
    """Phase 4g: admission, SLO shedding and fault containment through the
    compiled engine, at tinyllama-1.1b's full width on the serve phase's
    params and tables, then on mamba2-1.3b's with exact chunks. Returns the
    device launches of its counted runs (the fault-free, zero-plan and two
    chaos runs), per kernel."""
    import statistics
    import tempfile

    from repro_torch.launch.report import render
    from repro_torch.obs import (RecompileSentinel, Tracer, load,
                                 to_chrome_trace, validate)
    from repro_torch.serving import (EngineStuckError, FaultEvent, FaultPlan,
                                     ServeEngine, WorkloadSpec, make_trace)
    t_phase = time.monotonic()
    cfg, dev = engine.cfg, engine.device
    trace = make_trace(WorkloadSpec(**ADMIT_SPEC), cfg.vocab_size)
    twin = _CpuTwin()
    keys = {RecompileSentinel.key(k, cfg.name): 1
            for k in ("decode", "prefill_chunk_exact", "reset")}

    class TimedTracer(Tracer):
        """A tracer that keeps the host time spent in its own methods."""
        spent = 0.0

        def _timed(self, fn, *a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            self.spent += time.perf_counter() - t
            return out

        def begin(self, *a, **kw):
            return self._timed(super().begin, *a, **kw)

        def end(self, *a, **kw):
            return self._timed(super().end, *a, **kw)

        def event(self, *a, **kw):
            return self._timed(super().event, *a, **kw)

        def interval(self, *a, **kw):
            return self._timed(super().interval, *a, **kw)

    def build(plan=None, tracer=None, ticks=None, **kw):
        e = ServeEngine(cfg, engine.params, **{**ADMIT_GEOMETRY, **kw},
                        stacked_tables=tables, fault_plan=plan,
                        tracer=tracer, device=dev)
        if ticks is not None:
            # each tick's wall µs and the tracer's own µs in it
            tick = e.tick

            def timed():
                t, spent = time.perf_counter(), getattr(tracer, "spent", 0)
                tick()
                ticks.append((1e6 * (time.perf_counter() - t),
                              1e6 * (getattr(tracer, "spent", 0) - spent)))
            e.tick = timed
        return e

    def counted(plan=None, traced=False, **engine_kw):
        """One run of ``trace`` through a new engine under the profiler
        (``_counted_run``: device launches == obs.per_call x calls);
        returns (engine, outputs, device launches, tick times)."""
        box = {}

        def fresh():
            box["ticks"] = []
            tracer = TimedTracer(arch=cfg.name) if traced else None
            return build(plan, tracer, box["ticks"], **engine_kw)
        e, out, device, _, _ = _counted_run(fresh(), trace, fresh)
        assert e.sentinel.counts() == keys, e.sentinel.counts()
        return e, out, device, box["ticks"]

    # -- SPF against FIFO ----------------------------------------------
    fifo, out_f, dev_f, _ = counted()
    s_f = fifo.metrics.summary()
    T = s_f["engine_ticks"]
    spf = build(schedule="spf", spf_age_cap=SPF_AGE_CAP)
    out_s = spf.run(trace)
    assert out_s == out_f and set(out_f) == {r.rid for r in trace}
    assert all(torch.equal(row, fifo.first_logits[rid])
               for rid, row in spf.first_logits.items())
    skips = [r.skips for r in spf.metrics.requests.values()]
    order = {e: [iv.rid for iv in sorted(e.slot_log, key=lambda iv: (
        iv.admit_tick, iv.slot))] for e in (fifo, spf)}
    assert max(skips) <= SPF_AGE_CAP and order[spf] != order[fifo]
    log(f"[admit] FIFO {T} ticks, {s_f['device_calls']} calls "
        f"(admission order {order[fifo]}); SPF (age cap {SPF_AGE_CAP}) "
        f"{spf.metrics.summary()['engine_ticks']} ticks, admission order "
        f"{order[spf]}, skips max {max(skips)}: all 12 streams and "
        f"first-token logits bitwise FIFO's")
    del spf

    # -- SLO --------------------------------------------------------------
    slo_trace = make_trace(WorkloadSpec(**ADMIT_SPEC,
                                        deadline_slack=SLO_SLACK),
                           cfg.vocab_size)
    slo_plan = FaultPlan(events=tuple(FaultEvent(**e) for e in SLO_EVENTS))
    slo = build(slo_plan, queue_cap=SLO_QUEUE_CAP)
    out_slo = slo.run(slo_trace)
    rows = slo.metrics.requests
    assert all(r.outcome in ("done", "shed", "rejected")
               for r in rows.values()) and len(rows) == len(slo_trace)
    shed_q = [r.rid for r in rows.values()
              if r.outcome == "shed" and r.admitted_tick is None]
    shed_s = [r.rid for r in rows.values()
              if r.outcome == "shed" and r.admitted_tick is not None]
    rejected = [r.rid for r in rows.values() if r.outcome == "rejected"]
    assert shed_q and shed_s and rejected, (shed_q, shed_s, rejected)
    assert sorted(_streams_hold(out_slo, slo, out_f)) == sorted(shed_s)
    cpu = twin.run(slo_trace, slo_plan, queue_cap=SLO_QUEUE_CAP)
    assert _schedule(slo) == _schedule(cpu), "SLO schedule vs the CPU's"
    log(f"[admit] SLO (deadlines {SLO_SLACK:g} ticks after arrival, queue "
        f"cap {SLO_QUEUE_CAP}, faults on request 4's slot at ticks 40 and "
        f"41): done {sorted(out_slo.keys() - set(shed_s))}, shed from the "
        f"queue {shed_q}, shed from a slot {shed_s} (partial streams "
        f"{[len(out_slo[r]) for r in shed_s]} tokens, prefixes of FIFO's), "
        f"rejected {rejected}; served streams FIFO's; per-request ticks "
        f"(admitted, first token, done), outcomes and slot log equal the "
        f"reduced CPU engine's on the same lengths")
    del slo

    # -- chaos ------------------------------------------------------------
    plan = FaultPlan.generate(n_ticks=T, n_slots=ADMIT_GEOMETRY["n_slots"],
                              **CHAOS)
    chaos_kw = dict(max_step_retries=CHAOS_RETRIES,
                    max_replays=CHAOS_REPLAYS)
    chaos, out_c, dev_c, ticks_c = counted(plan, **chaos_kw)
    traced, out_t, dev_t, ticks_t = counted(plan, traced=True, **chaos_kw)
    s_c, s_t = chaos.metrics.summary(), traced.metrics.summary()
    assert out_t == out_c and dev_t == dev_c, (dev_t, dev_c)
    for key in ("engine_ticks", "calls_by_kind", "faults", "retries",
                "replays", "n_shed"):
        assert s_t[key] == s_c[key], key
    shed_c = _streams_hold(out_c, chaos, out_f)
    assert all(chaos.metrics.requests[r].reason == "fault_budget"
               for r in shed_c)
    records = traced.tracer.records
    audit = _fault_audit(plan, records, CHAOS_RETRIES)
    assert not audit["unexplained"], audit
    assert s_c["faults"] == {k: n for k, n in audit["counts"].items() if n}, \
        (s_c["faults"], audit)
    assert s_c["device_calls"] == sum(s_c["calls_by_kind"].values())
    spans = [r for r in records if r.get("type") == "span"]
    assert sum(r["name"] == "call" and r["attrs"]["ok"]
               for r in spans) == s_c["device_calls"]
    # the serve CLI's --trace-out waterfalls, one a call kind: computed
    # after the run, launching nothing (check_waterfall)
    for kind, w in check_waterfall(traced, tables, "admit").items():
        traced.tracer.waterfall(kind, w["rows"], w["total"])
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "chaos.jsonl")
        traced.tracer.dump(path)
        loaded = load(path)
    stats = validate(loaded)
    report = render(loaded)
    chrome = to_chrome_trace(loaded)["traceEvents"]
    assert "== FAULTS / RECOVERY ==" in report and chrome
    assert stats["waterfalls"] == 2, stats
    assert "== WEIGHT-TRAFFIC WATERFALL" in report
    cpu = twin.run(trace, plan, **chaos_kw)
    s_cpu = cpu.metrics.summary()
    by_kind = {k: s_c["calls_by_kind"].get(k, 0) - s_f["calls_by_kind"].get(
        k, 0) for k in s_c["calls_by_kind"]}
    log(f"[admit] chaos (FaultPlan.generate seed {CHAOS['seed']}, rate "
        f"{CHAOS['rate']}, {T} ticks: {len(plan.events)} events; retries "
        f"{CHAOS_RETRIES}, replays {CHAOS_REPLAYS}): {s_c['engine_ticks']} "
        f"ticks, {s_c['device_calls']} device calls "
        f"({s_c['calls_by_kind']}; fault-free {s_f['device_calls']}, "
        f"+{s_c['device_calls'] - s_f['device_calls']} by kind {by_kind}: "
        f"the replay prefills, and the calls of the "
        f"{s_c['engine_ticks'] - T} ticks the replays added; a retry "
        f"re-issues a call that never ran), faults {s_c['faults']} == the "
        f"plan's "
        f"landed events (NaN logits {audit['landed_nan']}; corruptions "
        f"detected {audit['detected']}, reset first by another quarantine "
        f"{audit['superseded']}, freed unread {audit['unread']}; no "
        f"quarantine unexplained), retries "
        f"{s_c['retries']}, replays {s_c['replays']}, shed {s_c['n_shed']} "
        f"(fault budget), rejected {s_c['n_rejected']}; every stream bitwise "
        f"the fault-free one{' or a prefix' if shed_c else ''}; device "
        f"launches " + ", ".join(f"{k} {n}" for k, n in dev_c.items() if n)
        + f" == obs.per_call x {s_c['device_calls']} calls; one signature "
        f"per step")
    log(f"[admit] the reduced CPU engine (plain attention, the reference's "
        f"reading of dead keys) under the same plan: {s_cpu['engine_ticks']} "
        f"ticks, {s_cpu['device_calls']} calls, faults {s_cpu['faults']}, "
        f"replays {s_cpu['replays']}: equal; schedule "
        f"{'equal' if _schedule(cpu) == _schedule(chaos) else 'DIFFERS'}")
    # row_attention reads dead keys' non-finite values as the reference
    # does, so the card's chaos run keeps the CPU twin's schedule
    for key in ("engine_ticks", "device_calls", "faults", "replays"):
        assert s_c[key] == s_cpu[key], (key, s_c[key], s_cpu[key])
    med = {name: (statistics.median(w for w, _ in ts),
                  statistics.median(t for _, t in ts))
           for name, ts in (("untraced", ticks_c), ("traced", ticks_t))}
    log(f"[admit] traced run == untraced: streams, device launches, ticks, "
        f"calls by kind and faults equal; with one waterfall record a call "
        f"kind embedded, the trace validates ({stats}), "
        f"renders ({len(report.splitlines())} lines) and converts "
        f"({len(chrome)} Chrome events); host µs a tick (median, under the "
        f"profiler): untraced {med['untraced'][0]:.1f}, traced "
        f"{med['traced'][0]:.1f}, the tracer's own {med['traced'][1]:.1f} "
        f"(mean {1e6 * traced.tracer.spent / s_t['engine_ticks']:.1f})")
    del chaos, traced

    # -- the zero plan ----------------------------------------------------
    zero, out_z, dev_z, _ = counted(FaultPlan.none())
    s_z = zero.metrics.summary()
    assert out_z == out_f and dev_z == dev_f, (dev_z, dev_f)
    for key in ("engine_ticks", "device_calls", "calls_by_kind"):
        assert s_z[key] == s_f[key], key
    assert s_z["n_faults"] == s_z["retries"] == s_z["replays"] == 0
    log(f"[admit] FaultPlan.none(): streams, {s_z['device_calls']} calls "
        f"and device launches equal the run without a plan")
    del zero

    # -- a corruption of a slot reset the tick before ---------------------
    dk_plan = FaultPlan(events=tuple(FaultEvent(**e)
                                     for e in DEAD_KEY_EVENTS))
    dk = build(dk_plan, Tracer())
    out_dk = dk.run(trace)
    cpu = twin.run(trace, dk_plan, tracer=Tracer())
    assert out_dk == out_f, "dead-key plan streams"
    got = (dk.metrics.summary()["faults"], dk.metrics.summary()["replays"])
    want = (cpu.metrics.summary()["faults"], cpu.metrics.summary()["replays"])
    # row_attention reads the poisoned rows past the replay's live keys as
    # the reference's 0 * v does: quarantined at the same ticks as the CPU
    q_card = [q[:2] for q in _quarantines(dk.tracer.records)]
    q_cpu = [q[:2] for q in _quarantines(cpu.tracer.records)]
    log(f"[admit] NaN logits on slot 0 at tick 10, then a corruption of the "
        f"reset slot at tick 11: streams bitwise FIFO's; faults and replays "
        f"card {got[0]}, {got[1]}, CPU (the reference's reading) {want[0]}, "
        f"{want[1]}; quarantines (tick, slot) card {q_card}, CPU {q_cpu}; "
        f"{dk.metrics.summary()['engine_ticks']} vs "
        f"{cpu.metrics.summary()['engine_ticks']} ticks")
    assert got == want, (got, want)
    assert q_card == q_cpu, (q_card, q_cpu)
    del dk

    # -- mamba2 with exact chunks -----------------------------------------
    exact = ssm_engine.cfg.scaled(prefill_exact=True)
    ssm_trace = make_trace(WorkloadSpec(**SSM_CHAOS_SPEC), exact.vocab_size)

    def ssm_build(plan=None, tracer=None):
        return ServeEngine(exact, ssm_engine.params, n_slots=4,
                           max_len=ssm_engine.max_len,
                           prefill_chunk=SSM_EXACT_CHUNK,
                           stacked_tables=ssm_tables, fault_plan=plan,
                           tracer=tracer, device=dev, **chaos_kw)
    ref_e = ssm_build()
    ssm_ref = ref_e.run(ssm_trace)
    T_ssm = ref_e.metrics.summary()["engine_ticks"]
    ssm_plan = FaultPlan(events=FaultPlan.generate(
        n_ticks=T_ssm, n_slots=4, **CHAOS).events
        + (FaultEvent(**SSM_CHAOS_EVENT),))
    ssm = ssm_build(ssm_plan, Tracer())
    out_m = ssm.run(ssm_trace)
    s_m = ssm.metrics.summary()
    shed_m = _streams_hold(out_m, ssm, ssm_ref)
    audit_m = _fault_audit(ssm_plan, ssm.tracer.records, CHAOS_RETRIES)
    assert not audit_m["unexplained"], audit_m
    assert s_m["faults"] == {k: n for k, n in audit_m["counts"].items()
                             if n}, (s_m["faults"], audit_m)
    assert audit_m["counts"]["cache_corruption"] >= 1
    assert audit_m["unread"] == 0, audit_m
    assert ssm.prefill_kind == "prefill_chunk_exact"
    assert set(ssm.sentinel.counts().values()) == {1}
    log(f"[admit] mamba2-1.3b, exact chunks of {SSM_EXACT_CHUNK}: "
        f"{len(ssm_trace)} requests, {T_ssm} ticks fault-free; the seed "
        f"{CHAOS['seed']} plan ({len(ssm_plan.events)} events, a corruption "
        f"of slot {SSM_CHAOS_EVENT['slot']} at tick "
        f"{SSM_CHAOS_EVENT['tick']} among them): {s_m['engine_ticks']} "
        f"ticks, faults {s_m['faults']} == landed (every corrupted state read "
        f"at its slot's next call: {audit_m['detected']} detected, "
        f"{audit_m['superseded']} reset first by another quarantine), "
        f"retries {s_m['retries']}, replays "
        f"{s_m['replays']}, shed {shed_m}; streams bitwise the fault-free "
        f"exact run's")
    del ref_e, ssm

    # -- EngineStuckError -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "stuck.jsonl")
        stuck = build(tracer=Tracer(arch=cfg.name, path=path),
                      max_ticks=STUCK_TICKS)
        try:
            stuck.run(trace)
        except EngineStuckError as e:
            err = e
        else:
            raise AssertionError("max_ticks did not stop the engine")
        assert err.outputs == stuck.outputs and err.outputs
        assert [iv.admit_tick for iv in err.slot_log] == [0] * 4
        assert err.summary["engine_ticks"] == STUCK_TICKS + 1
        assert err.trace_path == path
        stuck_stats = validate(load(path))
    log(f"[admit] max_ticks={STUCK_TICKS}: EngineStuckError after "
        f"{err.summary['engine_ticks']} ticks with {len(err.outputs)} "
        f"partial streams, {len(err.slot_log)} slot intervals, the summary "
        f"and the trace dumped to its path ({stuck_stats})")
    log(f"[admit] phase 4g took {time.monotonic() - t_phase:.1f} s")
    return {k: dev_f[k] + dev_z[k] + dev_c[k] + dev_t[k] for k in dev_f}


def _kill_chaos(build, restore, trace, crash_ticks, bound):
    """``trace`` through ``build(plan)`` killed after each of
    ``crash_ticks`` (EngineCrash), each time brought back by
    ``restore(plan)`` and resumed. Returns (outputs, the engines); asserts
    each restore's replayed prefill tokens <= ``bound(restore_stats)``,
    one compiled signature per step kind in every engine, and a journal
    that tells the streams whole."""
    from repro_torch.serving import EngineCrash, FaultEvent, FaultPlan
    from repro_torch.serving.journal import fold_records, read_journal
    plan = FaultPlan(events=tuple(FaultEvent(tick=t, kind="engine_crash")
                                  for t in crash_ticks))
    engine = build(plan)
    engines, restored, outputs = [engine], [], None
    try:
        outputs = engine.run(trace)
    except EngineCrash as e:
        last = e.tick
    while outputs is None:
        engine = restore(plan)
        assert engine.tick_count > last, (engine.tick_count, last)
        st = engine.restore_stats
        assert st["replayed_prefill_tokens"] <= bound(st), st
        engines.append(engine)
        restored.append(st)
        try:
            outputs = engine.resume()
        except EngineCrash as e:
            last = e.tick
    assert len(restored) == len(crash_ticks), restored
    for e in engines:
        assert max(e.sentinel.counts().values()) == 1, e.sentinel.counts()
    recs, _, torn = read_journal(engines[-1].journal.path)
    assert not torn and fold_records(recs)["tokens"] == outputs
    return outputs, engines


def phase_durability(engine, tables, ssm_engine, ssm_tables):
    """Phase 4h: the write-ahead journal, engine snapshots with
    kill-and-restore and the paged KV cache through the compiled engine, at
    tinyllama-1.1b's full width on the serve phase's params, tables and
    trace (batch 4, max-len 512, chunks of 64), then mamba2-1.3b's exact
    chunks. Returns the device launches of its counted runs (without and
    with the journal and snapshots, and the ample paged pool), per
    kernel."""
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.obs import RecompileSentinel
    from repro_torch.serving import ServeEngine, WorkloadSpec, make_trace
    from repro_torch.serving.journal import fold_records, read_journal
    t_phase = time.monotonic()
    cfg, dev = engine.cfg, engine.device
    args = serve.build_parser().parse_args(SERVE_ARGS)
    trace = serve.trace_from_args(args, cfg.vocab_size)
    geometry = dict(n_slots=args.batch, max_len=args.max_len,
                    prefill_chunk=args.prefill_chunk)
    keys = {RecompileSentinel.key(k, cfg.name): 1
            for k in ("decode", "prefill_chunk_exact", "reset")}
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)

    def build(plan=None, **kw):
        return ServeEngine(cfg, engine.params, **geometry,
                           stacked_tables=tables, fault_plan=plan,
                           device=dev, **kw)

    def durable(tag):
        """Journal and snapshot keywords into fresh paths under ``tag``."""
        d = root / tag
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        return dict(journal=str(d / "journal.jsonl"),
                    snapshot_dir=str(d / "snaps"),
                    snapshot_every=DUR_SNAPSHOT_EVERY)

    def counted(**kw):
        e, out, device, _, _ = _counted_run(build(**kw), trace,
                                            lambda: build(**kw))
        assert e.sentinel.counts() == keys, e.sentinel.counts()
        return e, out, device

    def restorer(tag, **kw):
        d = root / tag
        return lambda plan: ServeEngine.restore(
            cfg, engine.params, snapshot_dir=str(d / "snaps"),
            journal_path=str(d / "journal.jsonl"), stacked_tables=tables,
            fault_plan=plan, device=dev, **kw)

    # -- passivity ----------------------------------------------------------
    plain, out_p, dev_p = counted()
    s_p = plain.metrics.summary()
    jour, out_j, dev_j = counted(**durable("passive"))
    s_j = jour.metrics.summary()
    assert out_j == out_p and dev_j == dev_p, (dev_j, dev_p)
    for key in ("engine_ticks", "device_calls", "calls_by_kind"):
        assert s_j[key] == s_p[key], key
    recs, _, torn = read_journal(jour.journal.path)
    fold = fold_records(recs)
    assert not torn and fold["tokens"] == out_p and set(fold["done"]) == \
        set(out_p)
    first = plain.first_logits
    snaps = sorted(p.name for p in Path(jour.snapshot_dir).glob("step_*"))
    log(f"[dur] journal and snapshots (every {DUR_SNAPSHOT_EVERY} ticks): "
        f"streams, {s_j['device_calls']} device calls and device launches "
        f"({', '.join(f'{k} {n}' for k, n in dev_j.items() if n)}) equal "
        f"the run without them; {len(recs)} journal records fold to the "
        f"streams; snapshots kept {snaps}")
    del plain, jour

    # -- kill-and-restore ---------------------------------------------------
    def cadence(st):
        # the reference's bound: a slot re-enters at most one token for
        # each tick since the snapshot
        return DUR_SNAPSHOT_EVERY * max(st["slots_restored"], 1)
    out_k, engines = _kill_chaos(
        lambda plan: build(plan, **durable("kill")), restorer("kill"), trace,
        DUR_CRASH_TICKS, cadence)
    assert out_k == out_p, "kill-and-restore streams"
    stats = [e.restore_stats for e in engines[1:]]
    kinds = engines[1].metrics.summary()["calls_by_kind"]
    assert any(k.endswith("+restore") for k in kinds), kinds
    log(f"[dur] killed after ticks {list(DUR_CRASH_TICKS)}, restored "
        f"twice: all {len(out_k)} streams bitwise the uninterrupted run's; "
        f"restores " + "; ".join(
            f"from step {st['from_step']} at tick {st['resume_tick']}, "
            f"{st['slots_restored']} slots, {st['replayed_prefill_tokens']} "
            f"replayed <= {DUR_SNAPSHOT_EVERY} x {st['slots_restored']}, "
            f"{st['fresh_prefill_tokens']} fresh, "
            f"{st['journal_tail_records']} tail records" for st in stats)
        + f"; one signature per step kind in each of the {len(engines)} "
        f"engines; calls {kinds}")
    del engines

    # -- the paged cache ----------------------------------------------------
    paged = dict(paged=True, page_size=PAGE_SIZE)
    ample, out_a, dev_a = counted(**paged)
    s_a = ample.metrics.summary()
    assert out_a == out_p and dev_a == dev_p, (dev_a, dev_p)
    assert s_a["n_preemptions"] == 0 and \
        s_a["engine_ticks"] == s_p["engine_ticks"]
    assert all(torch.equal(ample.first_logits[r], first[r]) for r in first)
    log(f"[dur] ample paged pool ({ample.n_pages} pages of {PAGE_SIZE}): "
        f"streams, first-token logits, ticks and device launches equal the "
        f"contiguous run's, "
        f"one signature per step kind (the page table a copied operand), "
        f"pages used max {s_a['pages_used_max']}")
    del ample
    tight = build(**paged, n_pages=TIGHT_PAGES)
    out_t = tight.run(trace)
    s_t = tight.metrics.summary()
    assert out_t == out_p and s_t["n_preemptions"] >= 1, s_t["n_preemptions"]
    assert s_t["pages_used_max"] <= TIGHT_PAGES
    assert tight.page_alloc.free_pages == TIGHT_PAGES
    assert tight.sentinel.counts() == keys, tight.sentinel.counts()
    log(f"[dur] tight pool ({TIGHT_PAGES} pages): {s_t['n_preemptions']} "
        f"preemptions, {s_t['page_alloc_failures']} allocation waits, "
        f"{s_t['engine_ticks']} ticks (contiguous {s_p['engine_ticks']}); "
        f"every stream bitwise the contiguous run's")
    del tight
    out_pk, engines = _kill_chaos(
        lambda plan: build(plan, **paged, n_pages=TIGHT_PAGES,
                           **durable("paged")), restorer("paged"), trace,
        DUR_CRASH_TICKS, cadence)
    assert out_pk == out_p, "paged kill-and-restore streams"
    assert all(e.paged and e.n_pages == TIGHT_PAGES for e in engines)
    log(f"[dur] the tight pool killed after ticks {list(DUR_CRASH_TICKS)} "
        f"and restored twice (page tables, admission ages and the preempted "
        f"queue from the snapshot and the journal): streams bitwise; "
        f"replayed " + ", ".join(
            str(e.restore_stats["replayed_prefill_tokens"])
            for e in engines[1:]))
    del engines

    # -- mamba2, exact chunks -----------------------------------------------
    exact = ssm_engine.cfg.scaled(prefill_exact=True)
    ssm_trace = make_trace(WorkloadSpec(**SSM_CHAOS_SPEC), exact.vocab_size)
    ssm_kw = dict(n_slots=4, max_len=ssm_engine.max_len,
                  prefill_chunk=SSM_EXACT_CHUNK, stacked_tables=ssm_tables,
                  device=dev)
    ssm_ref = ServeEngine(exact, ssm_engine.params, **ssm_kw).run(ssm_trace)
    d = root / "ssm"

    def ssm_build(plan):
        d.mkdir()
        return ServeEngine(exact, ssm_engine.params, fault_plan=plan,
                           journal=str(d / "journal.jsonl"),
                           snapshot_dir=str(d / "snaps"),
                           snapshot_every=SSM_DUR_SNAPSHOT_EVERY, **ssm_kw)

    def ssm_restore(plan):
        return ServeEngine.restore(
            exact, ssm_engine.params, snapshot_dir=str(d / "snaps"),
            journal_path=str(d / "journal.jsonl"), stacked_tables=ssm_tables,
            fault_plan=plan, device=dev)
    def chunks(st):
        # a slot that was prefilling at the snapshot moved a whole chunk a
        # tick: the ticks lost times a chunk, a slot
        return ((st["resume_tick"] - st["from_step"]) * SSM_EXACT_CHUNK
                * max(st["slots_restored"], 1))
    out_m, engines = _kill_chaos(ssm_build, ssm_restore, ssm_trace,
                                 SSM_DUR_CRASH_TICKS, chunks)
    assert out_m == ssm_ref, "mamba2 kill-and-restore streams"
    assert engines[0].prefill_kind == "prefill_chunk_exact"
    log(f"[dur] mamba2-1.3b, exact chunks of {SSM_EXACT_CHUNK}, killed after "
        f"ticks {list(SSM_DUR_CRASH_TICKS)} (snapshots every "
        f"{SSM_DUR_SNAPSHOT_EVERY}): the conv windows and SSM states come "
        f"back through the snapshot, streams bitwise; restores "
        + "; ".join(f"{e.restore_stats['slots_restored']} slots, "
                    f"{e.restore_stats['replayed_prefill_tokens']} replayed "
                    f"in {e.restore_stats['resume_tick']} - "
                    f"{e.restore_stats['from_step']} lost ticks of chunks of "
                    f"{SSM_EXACT_CHUNK}" for e in engines[1:]))
    del engines
    tmp.cleanup()
    log(f"[dur] phase 4h took {time.monotonic() - t_phase:.1f} s")
    return {k: dev_p[k] + dev_j[k] + dev_a[k] for k in dev_p}


def _stack_build(args, cfg, dev, tag):
    """The serve CLI's engine, trace and tables for a dense-MLP config at
    full width (``init_stacked_serving``: every stacked projection drawn
    whole, in float32, cast to bf16, packed layer by layer and stripped);
    prints and bounds the build's peak device memory: the dense weights
    (the embedding, the unembedding unless tied, pixtral's patch_proj and
    every projection stack) + the packs + one float32 draw of the largest
    projection stack and its scaled copy. Returns (engine, trace, tables)."""
    from repro_torch.launch import serve
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    engine, trace, tables = serve.build_engine_and_trace(args, cfg)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base) / gib
    resident = (torch.cuda.memory_allocated(dev) - base) / gib
    packs, dense, _, _ = _memory_bound(cfg, tables)
    if "patch_proj" in engine.params:
        w = engine.params["patch_proj"]
        dense += w.numel() * w.element_size() / gib
    stack = max(t["w_blocks"].shape[0] * tables.static[name][0]
                * tables.static[name][1]
                for name, t in tables.arrays.items())
    draw = 2 * 4 * stack / gib
    bound = dense + packs + draw
    log(f"[{tag}] {cfg.name} ({cfg.n_layers} layers, d={cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, d_ff="
        f"{cfg.d_ff}, vocab {cfg.vocab_size}"
        + (", tied" if cfg.tie_embeddings else "")
        + f"): params + tables built on the "
        f"card in {secs:.2f} s; packs {packs:.3f} GiB; build peak "
        f"{peak:.3f} GiB over what was resident before (bound: dense "
        f"weights {dense:.3f} + packs + the float32 draw of the largest "
        f"stack and its scaled copy {draw:.3f} = {bound:.3f}); resident "
        f"after {resident:.3f} GiB (card total "
        f"{torch.cuda.memory_allocated(dev) / gib:.3f})")
    assert peak <= bound, (peak, bound)
    return engine, trace, tables


def phase_pixtral(dev):
    """pixtral-12b at full width and depth (40 layers, d 5,120, 32 / 8
    heads of 128, d_ff 14,336, vocab 131,072 untied, 256 stub patches) in
    joint mode, built on the card (peak under its bound). On
    ``make_train_batch(cfg, 2, 256, seed)``, 256 patches and 256 tokens a
    row: ``forward(frontend_embeds=...)`` (the joint kernel at M = 1,024)
    with its launches per call from the device records (280 joint, 40
    row_attention, 81 row_norm) and its last-position logits within
    LOGIT_REL_TOL x max|ref| of the same call through the plain versions;
    the prefill step (``launch.steps.build_prefill_step``,
    ``models.prefill``) on the same batch, text only as the reference's,
    bitwise ``forward`` over the tokens alone (its launches from the
    device records too); row 0's tokens, forward's last logits within
    LOGIT_REL_TOL x max|ref| of the engine's stepwise decode of them.
    Then phase_serve's checks on the serve phase's trace, text-only.
    Returns the two forward calls' and the serve run's device launches."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import forward
    from repro_torch.models.inputs import make_train_batch
    args = serve.build_parser().parse_args(PIXTRAL_SERVE_ARGS)
    cfg = get_config(args.arch, dbpim_mode=args.dbpim_mode)
    engine, trace, tables = _stack_build(args, cfg, dev, "fwd")
    assert obs.per_call(cfg) == PIXTRAL_PER_CALL, obs.per_call(cfg)
    batch = make_train_batch(cfg, PIXTRAL_BATCH, PIXTRAL_TOKENS,
                             seed=args.seed, device=dev)
    assert batch["frontend"].shape == (PIXTRAL_BATCH, cfg.n_patches,
                                       cfg.d_model)

    def patched():
        return forward(engine.params, batch["tokens"], cfg,
                       frontend_embeds=batch["frontend"], last_only=True,
                       tables=tables)
    got, device = _counted_forward(patched, PIXTRAL_PER_CALL, "fwd",
                                   "patch forward")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    patched()
    torch.cuda.synchronize()
    ms = 1e3 * (time.monotonic() - t0)
    with plain_versions():
        ref = patched().float()
    assert got.shape == (PIXTRAL_BATCH, 1, cfg.vocab_size)
    assert got.dtype == torch.bfloat16
    d, tol = _logit_gap(got, ref)
    assert d <= tol, (d, tol)
    log(f"[fwd] {cfg.name} forward(frontend_embeds=...) on make_train_batch "
        f"(2 rows x ({cfg.n_patches} patches + {PIXTRAL_TOKENS} tokens), S "
        f"= {cfg.n_patches + PIXTRAL_TOKENS}): device launches "
        + ", ".join(f"{k} {v}" for k, v in device.items())
        + f" (== {PIXTRAL_PER_CALL}); {ms:.2f} ms eager; last-position "
        f"logits (2, 1, V) bf16, kernel vs plain max|d|={d:.3e} (tol "
        f"{tol:.3e} = {LOGIT_REL_TOL} x max|ref|)")
    del ref
    step = build_prefill_step(cfg, stacked_tables=tables)
    text, step_device = _counted_forward(
        lambda: step(engine.params, batch), PIXTRAL_PER_CALL, "fwd",
        "prefill step")
    want = forward(engine.params, batch["tokens"], cfg, last_only=True,
                   tables=tables)
    assert torch.equal(text, want), (text.float() - want.float()).abs().max()
    assert not torch.equal(text, got)
    log(f"[fwd] {cfg.name} prefill step on the same batch: text only, as "
        f"the reference's (batch['frontend'] not passed on): bitwise "
        f"forward(tokens, last_only=True), {PIXTRAL_TOKENS} positions a "
        f"row; device launches "
        + ", ".join(f"{k} {v}" for k, v in step_device.items()))
    prompt = batch["tokens"][0].tolist()
    last = want[0, 0].cpu()
    del got, text, want
    step_ref = _stepwise_run(engine, tables, prompt)[0]
    d, tol = _logit_gap(last, step_ref)
    assert d <= tol, (d, tol)
    log(f"[fwd] {cfg.name} row 0's {len(prompt)} tokens without patches: "
        f"forward's last logits vs the engine's stepwise decode of them "
        f"(kernel path, batch 1) max|d|={d:.3e} (tol {tol:.3e} = "
        f"{LOGIT_REL_TOL} x max|ref|)")
    launches = phase_serve(dev, PIXTRAL_SERVE_ARGS, tag="fwd",
                           built=(engine, trace, tables))[0]
    return {k: launches.get(k, 0) + device.get(k, 0) + step_device.get(k, 0)
            for k in launches}


def phase_dense_variants(dev):
    """qwen3-8b, gemma-7b and stablelm-1.6b at full width and depth in
    joint mode, one at a time, each freed before the next is built: built
    on the card (peak under its bound, ``_stack_build``), then
    phase_serve's checks on the serve phase's trace (launches per call
    from the device records == DENSE_PER_CALL == obs.per_call, compiled ==
    eager bitwise, one signature per step kind, first-token logits of two
    requests within LOGIT_REL_TOL x max|ref| of the plain path, chunk ==
    stepwise op by op and over a whole prompt); forward(last_only) over
    the first request's first DENSE_FWD_S prompt tokens within
    LOGIT_REL_TOL x max|ref| of the engine's stepwise decode of them; the
    decode call's bytes bound (packs + unembedding at 3.35 TB/s) printed.
    Returns the device launches of the three serve runs."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import forward
    total = {}
    for arch, want in DENSE_PER_CALL.items():
        argv = ["--arch", arch] + SERVE_ARGS[2:]
        args = serve.build_parser().parse_args(argv)
        cfg = get_config(args.arch, dbpim_mode=args.dbpim_mode)
        assert obs.per_call(cfg) == want, (arch, obs.per_call(cfg))
        built = _stack_build(args, cfg, dev, "dense")
        trace = built[1]
        launches, engine, eager, tables = phase_serve(
            dev, argv, tag="dense", built=built)
        del built, eager
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        prompt = list(trace[0].prompt[:DENSE_FWD_S])
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        last = forward(engine.params, toks, cfg, last_only=True,
                       tables=tables)[0, 0].cpu()
        d, tol = _logit_gap(last, _stepwise_run(engine, tables, prompt)[0])
        assert d <= tol, (arch, d, tol)
        wf = WATERFALLS[cfg.name]["decode"]
        packs, unembed, _ = _hand_terms(wf, tables, cfg)
        bound_ms = 1e3 * wf["total"] / HBM_BYTES_PER_S
        log(f"[dense] {cfg.name} forward(last_only) over request 0's first "
            f"{len(prompt)} prompt tokens vs the engine's stepwise decode of "
            f"them (kernel path, batch 1) max|d|={d:.3e} (tol {tol:.3e} = "
            f"{LOGIT_REL_TOL} x max|ref|); decode call bytes bound "
            f"{bound_ms:.3f} ms (the decode waterfall's "
            f"{wf['total'] / 1e9:.4f} GB at 3.35 TB/s: packs read "
            f"{packs / 1e9:.4f} GB + unembedding {unembed / 1e9:.4f} GB, "
            f"the hand sum's)")
        del engine, tables, last
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return total


def phase_window_forward(dev):
    """Reduced mixtral (window 32) in float32 on the card, built with its
    joint tables by ``init_stacked_serving``: forward over 2 x 96 tokens
    (past the window), every position's logits through the kernels within
    MIXTRAL_F32_REL x max|ref| of the plain path's. Returns the host
    launches (eager: every launch is one)."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models import forward
    from repro_torch.sparsity.sparse_linear import init_stacked_serving
    cfg = get_config("mixtral-8x7b", reduced=True,
                     dbpim_mode="joint").scaled(dtype="float32")
    assert cfg.window and MIXTRAL_FWD_S > cfg.window
    params, tables = init_stacked_serving(cfg, seed=0, device=dev)
    gen = torch.Generator().manual_seed(22)
    toks = torch.randint(0, cfg.vocab_size, (2, MIXTRAL_FWD_S),
                         generator=gen).to(dev)
    reset_launches()
    got = forward(params, toks, cfg, tables=tables)
    torch.cuda.synchronize()
    counts = read_launches()
    want = obs.per_call(cfg)
    assert all(counts[k] == want.get(k, 0) for k in counts), counts
    with plain_versions():
        ref = forward(params, toks, cfg, tables=tables)
    peak = ref.abs().max().item()
    d = (got - ref).abs().max().item()
    assert torch.isfinite(got).all() and d <= MIXTRAL_F32_REL * peak, \
        (d, peak)
    log(f"[fwd] reduced {cfg.name} (window {cfg.window}) float32, forward "
        f"over (2, {MIXTRAL_FWD_S}) tokens: all logits kernel vs plain "
        f"max|d|={d:.3e} (tol {MIXTRAL_F32_REL} x {peak:.3f}); launches "
        + ", ".join(f"{k} {counts[k]}" for k in want))
    return counts


def family_forward(engine, tables, tag):
    """``forward(last_only=True)`` on a served family's resident params and
    tables (an enc-dec engine's encoder output for its first rows) over 2
    rows of FAMILY_FWD_S tokens: launches per call obs.per_call's, and the
    last logits against the plain path's within the serve phase's bounds
    (LOGIT_REL_TOL of the peak; with a tied embedding, of the peak past the
    echo of each row's last token, and the layers' output within
    LOGIT_REL_TOL of its own peak). Returns the host launches."""
    from repro_torch import obs
    from repro_torch.models import forward
    from repro_torch.models.layers import embed_tokens
    cfg, dev = engine.cfg, engine.device
    gen = torch.Generator().manual_seed(23)
    toks = torch.randint(1, cfg.vocab_size, (2, FAMILY_FWD_S),
                         generator=gen).to(dev)
    enc = engine.cache.get("enc_out")
    enc = None if enc is None else enc[:2]

    def run():
        with _forward_final_norm_inputs(engine.params) as rows:
            lg = forward(engine.params, toks, cfg, enc_out=enc,
                         last_only=True, tables=tables)
        emb = embed_tokens(engine.params["embed"], toks[:, -1:], cfg)
        return lg[:, 0].float(), (rows[0][:, -1:] - emb).float()[:, 0]

    reset_launches()
    got, stack = run()
    torch.cuda.synchronize()
    counts = read_launches()
    want = obs.per_call(cfg)
    assert all(counts[k] == want.get(k, 0) for k in counts), counts
    with plain_versions():
        ref, ref_stack = run()
    assert torch.isfinite(got).all()
    others = torch.ones_like(ref, dtype=torch.bool)
    if cfg.tie_embeddings:
        others[torch.arange(2, device=dev), toks[:, -1].long()] = False
    d = (got - ref).abs().max().item()
    peak = ref[others].abs().max().item()
    assert d <= LOGIT_REL_TOL * peak, (cfg.name, d, peak)
    msg = (f"[{tag}] {cfg.name} forward(last_only) over (2, {FAMILY_FWD_S}) "
           f"tokens" + (" with the engine's enc_out" if enc is not None
                        else "") + f" on its resident params and tables: "
           f"launches " + ", ".join(f"{k} {counts[k]}" for k in want)
           + f"; last logits kernel vs plain max|d|={d:.3e} (tol "
           f"{LOGIT_REL_TOL} x {peak:.3f}, max|ref|"
           + (" past the echo of the last tokens)" if cfg.tie_embeddings
              else ")"))
    if cfg.tie_embeddings:
        sd = (stack - ref_stack).abs().max().item()
        speak = ref_stack.abs().max().item()
        assert sd <= LOGIT_REL_TOL * speak, (cfg.name, sd, speak)
        msg += (f"; the layers' output max|d|={sd:.3e} (tol "
                f"{LOGIT_REL_TOL} x {speak:.3f})")
    log(msg)
    return counts


def _full_width_layer(cfg, dev):
    """One tinyllama-1.1b decoder layer's params at full width, random
    from a seeded generator on the card."""
    from repro_torch.models.attention import init_attention
    from repro_torch.models.layers import init_mlp, init_norm
    gen = torch.Generator(device=dev).manual_seed(4)
    return {"norm1": init_norm(cfg, cfg.d_model, dev),
            "attn": init_attention(cfg, gen, dev),
            "norm2": init_norm(cfg, cfg.d_model, dev),
            "mlp": init_mlp(cfg, gen, cfg.d_model, cfg.d_ff, dev)}


def _run_layer(cfg, p, x, mm):
    """x (B, S, D) through norm -> chunked attention into an empty cache
    -> residual -> norm -> MLP -> residual, the projections through mm."""
    from repro_torch.models.attention import prefill_attention
    from repro_torch.models.layers import apply_mlp, apply_norm
    B, S, _ = x.shape
    kv = torch.zeros((B, S, cfg.n_kv_heads, cfg.hd), dtype=x.dtype,
                     device=x.device)
    y, _, _ = prefill_attention(
        p["attn"], apply_norm(p["norm1"], x, cfg), kv, kv.clone(),
        torch.zeros((B,), dtype=torch.int32, device=x.device),
        torch.full((B,), S, dtype=torch.int32, device=x.device), cfg,
        dense_fn=mm)
    h = x + y
    return h + apply_mlp(p["mlp"], apply_norm(p["norm2"], h, cfg), cfg,
                         dense_fn=mm)


def phase_modes(dev):
    """One full-width layer through the per-layer kernel-mode hook in modes
    value and bit. Returns (launches per kernel over the path, the packed
    named tables per mode)."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import make_matmul
    from repro_torch.sparsity.sparse_linear import build_kernel_tables
    kernel_of = {"value": "block_sparse_matmul", "bit": "fta_int8_matmul"}
    base = get_config("tinyllama-1.1b")
    p = _full_width_layer(base, dev)
    named = {**{k: p["attn"][k] for k in ("wq", "wk", "wv", "wo")},
             **p["mlp"]}
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((4, 64, base.d_model), generator=gen)
    x = x.to(torch.bfloat16).to(dev)
    x1 = x[:, :1].contiguous()
    counts, tables_by_mode = {}, {}
    for mode, kname in kernel_of.items():
        cfg = base.scaled(dbpim=True, dbpim_mode=mode,
                          dbpim_value_sparsity=0.6)
        tables = build_kernel_tables(named, cfg)
        assert {t["kind"] for t in tables.values()} == {mode}, mode
        tables_by_mode[mode] = tables
        mm = make_matmul(cfg, tables)
        torch.cuda.synchronize()
        reset_launches()
        y = _run_layer(cfg, p, x, mm)
        torch.cuda.synchronize()
        per_call = read_launches()
        assert per_call == {**{k: 0 for k in per_call}, kname: 7,
                            "row_attention": 1, "row_norm": 2}, \
            (mode, per_call)
        counts[kname] = per_call[kname]
        with plain_versions():
            ref = _run_layer(cfg, p, x, mm)
        peak = ref.float().abs().max().item()
        err = (y.float() - ref.float()).abs().max().item()
        assert torch.isfinite(y).all() and err <= LAYER_REL_TOL * peak, \
            (mode, err, peak)
        reset_launches()
        _run_layer(cfg, p, x1, mm)
        torch.cuda.synchronize()
        decode_launches = read_launches()[kname]
        log(f"[modes] {mode}: one full-width layer at 4 x 64 = 256 rows, "
            f"{per_call[kname]} {kname} launches; vs plain versions "
            f"max|d|={err:.3e} (max|ref|={peak:.3f}, tol {LAYER_REL_TOL} x "
            f"max|ref|); a 4-row decode call launches it "
            f"{decode_launches} times (rows % 128 != 0: the reference's "
            f"plain math)")
    return counts, tables_by_mode


def phase_compression(dev):
    """Phase 5b: the DB-PIM compression leftovers at tinyllama-1.1b's full
    width on the card. ``sparsify_params`` over its 154 projection slices
    (1 x 8 block pruning at cfg's value sparsity, one INT8 scale a slice,
    FTA), the artifacts on the card, one slice's q, mask, scale and pad
    byte for byte the host's ``_compress_2d`` of the same slice;
    ``pim_speedup_estimate`` printed; ``quantize_params_for_serving`` on
    the card, the same slice's q and per-filter scale byte for byte the
    host's; the int8 "serve" step (dequantized inside the step) for 8
    lock-step decode steps at batch 4, its logits bitwise the dense
    "serve" step's over ``dequant_params_for_serving`` of the same
    quantized params, and both steps' waterfalls (``op_cost.analyze``)
    printed. Returns the launches of its counted calls (the 16 steps'
    row_attention and row_norm), per kernel."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_step
    from repro_torch.models import init_cache, init_params
    from repro_torch.runtime import op_cost
    from repro_torch.sparsity import (dequant_params_for_serving,
                                      pim_speedup_estimate,
                                      quantize_params_for_serving,
                                      sparsify_params)
    from repro_torch.sparsity.sparse_linear import _compress_2d
    cfg = get_config("tinyllama-1.1b")
    t0 = time.monotonic()
    params = init_params(cfg, seed=COMPRESS_SEED, device=dev)
    comp = sparsify_params(params, cfg)
    torch.cuda.synchronize()
    t_sparsify = time.monotonic() - t0
    key, l = COMPRESS_SLICE
    node = params
    for part in key.split("/"):
        node = node[part]
    t0 = time.monotonic()
    q, scale, mask, _, pad = _compress_2d(node[l].float().cpu(),
                                          cfg.dbpim_value_sparsity, 8)
    card = comp.tensors[key]
    assert len(comp.tensors) == 7 and all(
        t["q"].device.type == dev.type and t["q"].dtype == torch.int8
        for t in comp.tensors.values())
    assert torch.equal(card["q"][l].cpu(), q.to(torch.int8))
    assert torch.equal(card["mask"][l].cpu(), mask.to(torch.int8))
    assert torch.equal(card["scale"][l:l + 1].cpu().view(torch.int32),
                       torch.tensor([scale]).view(torch.int32))
    assert card["pad"] == pad == 0
    t_host = time.monotonic() - t0
    t0 = time.monotonic()
    est = pim_speedup_estimate(comp, cfg)
    t_est = time.monotonic() - t0
    rep = comp.report[key]
    log(f"[compress] {cfg.name} sparsify_params on the card: "
        f"{len(comp.tensors)} stacked projections, "
        f"{sum(t['q'].shape[0] for t in comp.tensors.values())} slices, "
        f"{sum(t['q'].numel() for t in comp.tensors.values()) / 1e9:.3f} G "
        f"INT8 weights, in {t_sparsify:.2f} s (the draw included); {key} "
        f"slice {l} (q {tuple(card['q'][l].shape)}): q, mask, scale "
        f"{scale:.6e} and pad byte for byte the host's in {t_host:.2f} s; "
        f"layer 0: value sparsity {rep['value_sparsity']:.4f}, bit "
        f"sparsity {rep['bit_sparsity']:.4f}, phi histogram "
        f"{rep['phi_hist']}; pim_speedup_estimate (64 tokens, layer-0 "
        f"sparsity of each projection) speedup {est['speedup']:.4f}, energy "
        f"savings {est['energy_savings']:.4f}, U_act {est['u_act']:.4f} "
        f"in {t_est:.2f} s")
    del comp, node
    t0 = time.monotonic()
    qparams = quantize_params_for_serving(params)
    # one slice of one projection quantized on the host, byte for byte the
    # card's: q as int8, the per-filter scale through its int32 view
    path = key.split("/")
    host = params
    for part in path:
        host = host[part]
    sub = host[l:l + 1].cpu()
    for part in reversed(path):
        sub = {part: sub}
    hq, qcard = quantize_params_for_serving(sub), qparams
    for part in path:
        hq, qcard = hq[part], qcard[part]
    assert torch.equal(qcard["q"][l:l + 1].cpu(), hq["q"])
    assert torch.equal(qcard["scale"][l:l + 1].cpu().view(torch.int32),
                       hq["scale"].view(torch.int32))
    t_qhost = time.monotonic() - t0
    del params, host, sub, hq
    deq = dequant_params_for_serving(qparams)
    int8 = build_step(cfg, "serve", int8_weights=True)
    dense = build_step(cfg, "serve")
    gen = torch.Generator().manual_seed(COMPRESS_SEED)
    B, T = INT8_SERVE_B, INT8_SERVE_STEPS
    toks = torch.randint(0, cfg.vocab_size, (T, B, 1), generator=gen,
                         dtype=torch.int32).to(dev)
    c_int8 = c_dense = init_cache(cfg, B, T, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    for t in range(T):
        a, c_int8 = int8(qparams, c_int8, toks[t])
        b, c_dense = dense(deq, c_dense, toks[t])
        assert a.shape == (B, 1, cfg.vocab_size) and torch.isfinite(a).all()
        assert torch.equal(a, b), t
    torch.cuda.synchronize()
    counts = read_launches()
    assert counts == {**{k: 0 for k in counts},
                      "row_attention": 2 * T * cfg.n_layers,
                      "row_norm": 2 * T * (2 * cfg.n_layers + 1)}, counts
    t_steps = time.monotonic() - t0
    t0 = time.monotonic()
    cache = init_cache(cfg, B, T, device=dev)
    wi = op_cost.analyze(int8, qparams, cache, toks[0])
    wd = op_cost.analyze(dense, deq, cache, toks[0])
    t_wf = time.monotonic() - t0
    untagged = wi["weight_bytes_by_path"].get(op_cost.UNTAGGED_DOT, 0)
    int8_bytes = sum(v.numel() for k, v in _flat(qparams).items()
                     if k.endswith("/q"))
    assert untagged == 2 * int8_bytes and wi["weight_bytes"] == \
        wd["weight_bytes"], (untagged, int8_bytes)
    log(f"[compress] int8 \"serve\" step, {T} lock-step decode steps at "
        f"batch {B}: {key} slice {l} quantized on the card (q "
        f"{tuple(qcard['q'][l].shape)}, scale {tuple(qcard['scale'][l].shape)})"
        f" byte for byte the host's in {t_qhost:.2f} s; logits (B, 1, V) "
        f"bitwise the dense \"serve\" step's "
        f"over the dequantized params; {counts['row_attention']} "
        f"row_attention and {counts['row_norm']} row_norm launches over "
        f"the 16 steps, no joint launch (plain matmuls), in {t_steps:.2f} s "
        f"(quantizing included); waterfalls: int8 step "
        f"{wi['weight_bytes']:.0f} B, of which the untagged dot rhs "
        f"{untagged:.0f} (its {int8_bytes} INT8 weights charged at bf16 "
        f"size, as the reference's walker charges them), dense step "
        f"{wd['weight_bytes']:.0f} B, in {t_wf:.2f} s")
    COST_SECONDS.update({"5b sparsify": t_sparsify, "5b host slice": t_host,
                         "5b estimate": t_est, "5b int8 steps": t_steps,
                         "5b step waterfalls": t_wf})
    return counts


def phase_dbmu(cfg, dev):
    """The quickstart pipeline at every projection shape on the card, then
    the quickstart itself. Returns the dbmu_matmul launches of the path."""
    from repro_torch import quickstart
    from repro_torch.core import pruning
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(7)
    data = []
    for name, K, N in _distinct(_path_shapes(cfg)):
        w = torch.randn((K, N), generator=gen) * K ** -0.5
        x = _int8_extremes(torch.randint(-128, 128, (256, K), generator=gen,
                                         dtype=torch.int32))
        data.append((name, K, N, w, x))
    torch.cuda.synchronize()
    reset_launches()
    for name, K, N, w, x in data:
        t0 = time.monotonic()
        mask = pruning.block_prune_mask(w.to(dev), 0.6, alpha=8)
        q, scale, packed, phi = ops.fta_pack(w.to(dev), mask)
        y = ops.dbmu_reference_check(x.to(dev), packed)
        want = ref.dbmu_matmul_ref(x.to(dev), packed)
        torch.cuda.synchronize()
        t_card = time.monotonic() - t0
        assert torch.equal(y.long(), want), (name, "dbmu")
        mask_cpu = pruning.block_prune_mask(w, 0.6, alpha=8)
        q_cpu, scale_cpu, packed_cpu, phi_cpu = ops.fta_pack(w, mask_cpu)
        for a, b, what in ((mask, mask_cpu, "mask"), (q, q_cpu, "q"),
                           (packed, packed_cpu, "packed"),
                           (phi, phi_cpu, "phi")):
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b), \
                (name, what)
        assert float(scale) == float(scale_cpu)
        log(f"[dbmu] {name} {K}x{N}: value sparsity "
            f"{pruning.value_sparsity(mask):.3f}, phi_th histogram "
            f"{torch.bincount(phi.long(), minlength=3).tolist()}; card "
            f"mask/INT8/terms == cpu byte for byte; dbmu_matmul M=256 == "
            f"integer matmul exactly ({t_card:.2f} s on the card)")
    res = quickstart.run("cuda")
    torch.cuda.synchronize()
    counts = read_launches()
    assert res["pack_exact"] and res["dbmu_exact"] and \
        res["joint_err"] < 1e-5, res
    assert counts["dbmu_matmul"] == len(data) + 1, counts
    log(f"[dbmu] quickstart on the card: pack/unpack exact, DBMU bit-true, "
        f"speedup {res['speedup']:.2f}x, joint kernel max|d| "
        f"{res['joint_err']:.2e}; dbmu_matmul launches on the path "
        f"{counts['dbmu_matmul']}")
    return counts["dbmu_matmul"]


#: phase 6b (paper): the CNNs' value sparsity and the layer kinds the
#: cost model accelerates; Fig. 11's bands of VGG19 (speedup and energy
#: saving over the dense baseline, joint mode without the input bit skip,
#: unpruned and at 0.6), which tests/test_pim_model.py holds the reference
#: to; the joint kernel at the paper's layer shapes: the draws of
#: benchmarks/kernel_bench.py's joint cases (seed, tile sparsity) and the
#: rows (joint_bench_shapes' cap on M)
PAPER_VS = 0.6
PAPER_ACCEL = ("std", "pw", "fc")
VGG19_FIG11_BANDS = {0.0: ((4.5, 6.5), (0.65, 0.80)),
                     0.6: ((7.0, 9.5), (0.80, 0.93))}
PAPER_PACK_SEED, PAPER_PACK_SPARSITY, PAPER_M = 7, 0.5, 128
JOINT_PAPER_UNIT = "joint_sparse_matmul paper shapes"


def _np_tile_mask(rng, K, N, sparsity, tile=128):
    """The reference's ``ops.random_tile_mask`` on a numpy generator, as
    the kernel benchmark draws it: whole (tile x tile) survivors (at least
    one), cropped to (K, N), int32."""
    import numpy as np
    kt, nt = -(-K // tile), -(-N // tile)
    alive = rng.random((kt, nt)) >= sparsity
    if not alive.any():
        alive[0, 0] = True
    return np.repeat(np.repeat(alive, tile, 0), tile, 1)[:K, :N].astype(
        np.int32)


def _paper_metadata(dev):
    """(a): model_metadata of each of the five CNNs (their accelerated
    layers, seed 0) on the card equal to the host's field for field, at
    PAPER_VS and, for VGG19, unpruned; the cost model's joint mode and
    Fig. 11's setting against the dense baseline; VGG19 in its bands."""
    import dataclasses

    from repro_torch.configs.paper_cnns import CNN_MODELS, MODE_FLAGS
    from repro_torch.core import pim_model as pm
    from repro_torch.core.workload_gen import model_metadata
    fig11 = dict(MODE_FLAGS["joint"], use_input_bit=False)
    cases = [(m, PAPER_VS) for m in CNN_MODELS] + [("vgg19", 0.0)]
    for model, vs in cases:
        layers = [l for l in CNN_MODELS[model]() if l.kind in PAPER_ACCEL]
        t0 = time.monotonic()
        card = model_metadata(layers, vs, model, seed=0, device=dev)
        t_card = time.monotonic() - t0
        t0 = time.monotonic()
        host = model_metadata(layers, vs, model, seed=0, device="cpu")
        t_host = time.monotonic() - t0
        assert list(card) == list(host), model
        for name in host:
            assert dataclasses.astuple(card[name]) == \
                dataclasses.astuple(host[name]), (model, vs, name)
        dense = pm.evaluate_dense_baseline(layers)
        gains = {}
        for what, flags in (("joint", MODE_FLAGS["joint"]),
                            ("fig11", fig11)):
            rep = pm.evaluate_model(layers, card, **flags)
            gains[what] = (dense.cycles / rep.cycles,
                           1 - rep.energy_pj / dense.energy_pj)
        log(f"[paper] {model} at value sparsity {vs}: metadata of "
            f"{len(card)} layers on the card == the host's field for field "
            f"(card {t_card:.2f} s, host {t_host:.2f} s); over the dense "
            f"baseline: joint speedup {gains['joint'][0]:.3f}x, energy "
            f"saving {gains['joint'][1]:.2%}; Fig. 11's setting (no input "
            f"bit skip) {gains['fig11'][0]:.3f}x, {gains['fig11'][1]:.2%}")
        if model == "vgg19":
            (sp_lo, sp_hi), (es_lo, es_hi) = VGG19_FIG11_BANDS[vs]
            sp, es = gains["fig11"]
            assert sp_lo < sp < sp_hi and es_lo < es < es_hi, (vs, sp, es)
            log(f"[paper] vgg19 at {vs}: Fig. 11 speedup {sp:.3f}x in "
                f"({sp_lo}, {sp_hi}), energy saving {es:.4f} in ({es_lo}, "
                f"{es_hi})")


def phase_paper(dev):
    """Phase 6b: the paper side on the card. (a) ``_paper_metadata``. (b)
    The joint kernel at the six ``joint_bench_shapes(128)`` layer shapes,
    w and the tile mask drawn with numpy as the kernel benchmark draws
    them: the pack made on the card == the host's byte for byte; one
    counted ``ops.joint_dense`` call a shape on bf16 x (6 launches, the
    path's); then the kernel with bf16 and f32 x against its plain
    version (phase 3's tolerances) and the stored bytes over the dense
    bf16 bytes; the six launches timed together, one whole profiler
    window, beside the plain versions, torch.matmul on the dense bf16
    weights and the bytes bound. Returns (the counted launches, the worst
    bf16 error, the unit's times for the JSON line)."""
    import numpy as np

    from repro_torch.configs.paper_cnns import joint_bench_shapes
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    t_phase = time.monotonic()
    _paper_metadata(dev)
    bf16 = torch.bfloat16
    rng = np.random.default_rng(PAPER_PACK_SEED)
    cases = []
    for name, M, K, N in joint_bench_shapes(max_m=PAPER_M):
        w = torch.from_numpy(rng.laplace(0, 0.02, (K, N)).astype(np.float32))
        mask = torch.from_numpy(_np_tile_mask(rng, K, N, PAPER_PACK_SPARSITY))
        x = torch.from_numpy(rng.normal(0, 1, (M, K)).astype(np.float32))
        p = ops.pack_joint_sparse(w.to(dev), mask.to(dev))
        host = ops.pack_joint_sparse(w, mask)
        for field in ("w_blocks", "idx", "scales", "nblocks"):
            a, b = getattr(p, field).cpu(), getattr(host, field)
            assert a.dtype == b.dtype and torch.equal(a, b), (name, field)
        assert (p.k, p.n, p.k_pad) == (host.k, host.n, host.k_pad)
        x = x.to(dev)
        cases.append((name, K, N, p, x, x.to(bf16), w.to(bf16).to(dev)))
    torch.cuda.synchronize()
    reset_launches()
    ys = [ops.joint_dense(xb, p) for _, _, _, p, _, xb, _ in cases]
    torch.cuda.synchronize()
    counts = read_launches()
    assert counts["joint_sparse_matmul"] == len(cases) == 6, counts
    assert not any(n for k, n in counts.items()
                   if k != "joint_sparse_matmul"), counts
    worst = 0.0
    for (name, K, N, p, x, xb, _), y in zip(cases, ys):
        got, err = _joint_vs_plain(xb, p, f"{name} {K}x{N}", "paper")
        assert torch.equal(got, y), name
        worst = max(worst, err)
        _joint_vs_plain(x, p, f"{name} {K}x{N}", "paper")
        log(f"[paper] {name} {K}x{N}: card pack == host pack byte for byte; "
            f"MAXB {p.w_blocks.shape[1]} of {K // 128} K tiles; stored "
            f"{ops.joint_storage_bytes(p)} bytes = "
            f"{ops.joint_storage_bytes(p) / (2 * K * N):.4f} of the dense "
            f"bf16 {2 * K * N}")
    xs = [(xb, p, w) for _, _, _, p, _, xb, w in cases]

    def kernel_all():
        for x, p, _ in xs:
            jsm.joint_sparse_matmul(x, p.w_blocks, p.idx, p.scales)

    def plain_all():
        for x, p, _ in xs:
            jsm.joint_sparse_matmul_plain(x, p.w_blocks, p.idx, p.scales)

    def library_all():
        for x, _, w in xs:
            torch.matmul(x, w)

    nbytes = sum(x.numel() * 2 + p.w_blocks.numel() + p.idx.numel() * 4
                 + p.scales.numel() * 4 + x.shape[0] * p.n * 2
                 for x, p, _ in xs)
    n_ops = sum(2 * x.shape[0] * p.w_blocks.numel() for x, p, _ in xs)
    bound, by = _bound(nbytes, n_ops, BF16_FLOPS)
    t = dict(ms=_time_auto(kernel_all),
             device_ms=_device_ms(kernel_all, launches=len(xs)),
             plain_ms=_time_auto(plain_all), library_ms=_time_auto(library_all),
             library_device_ms=_device_ms(library_all, launches=0),
             host_us=_host_us(kernel_all) / len(xs), bytes=nbytes,
             ops=n_ops, bound_ms=bound, bound_by=by)

    def ms_(v):
        return "not measured" if v is None else f"{v:.4f} ms"
    log(f"[times] {JOINT_PAPER_UNIT}, {len(xs)} launches (one a shape, "
        f"M={PAPER_M}, bf16 x, one profiler window): kernel {ms_(t['ms'])} "
        f"(device {ms_(t['device_ms'])}), plain {ms_(t['plain_ms'])}, "
        f"torch.matmul on the dense bf16 weights {ms_(t['library_ms'])} "
        f"(device {ms_(t['library_device_ms'])}), bound {bound:.4f} ms "
        f"({by}, {nbytes / 1e6:.1f} MB); host {t['host_us']:.1f} us per "
        f"launch")
    log(f"[paper] phase 6b took {time.monotonic() - t_phase:.1f} s")
    return counts["joint_sparse_matmul"], worst, t


def _profile_window(window, n_calls, launches, setup=None):
    """(wall ms, busy ms, device ops, joint ms, device-side records, peak
    GiB, resident GiB) per call of ``window``: wall time, peak device
    memory and the memory allocated at its start from a run without the
    profiler, the rest from torch.profiler's device-side records of a
    second, identical run. That run counts only if its records hold
    ``launches`` ({kernel: the port's launches a call}) x ``n_calls`` of
    each of the port's kernels: the profiler loses records now and then,
    which would read as a shorter busy time. Up to 3 runs are taken; busy
    None if none is whole. ``setup`` runs before each run, outside the
    measurements."""
    from torch.profiler import ProfilerActivity, profile

    def fresh():
        if setup is not None:
            setup()
        torch.cuda.synchronize()

    fresh()
    window()                                   # warm-up
    fresh()
    base_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    window()
    wall_ms = 1e3 * (time.monotonic() - t0) / n_calls
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    seen = []
    for _ in range(3):
        fresh()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _pad()
            window()
            _pad()
        got = _device_records(prof)[2]
        seen.append({k: n - launches.get(k, 0) * n_calls
                     for k, n in got.items()})
        if not any(seen[-1].values()):
            break
    else:
        log(f"[profile]   no whole window: port launches short of "
            f"{launches} x {n_calls} by {seen}")
        return wall_ms, None, 0, 0.0, [], peak_gib, base_gib
    kernels = _device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_calls
    joint_ms = sum(e.self_device_time_total for e in kernels
                   if any(sym in e.key for sym in JOINT_SYMBOLS)) / 1e3 / n_calls
    ops = sum(e.count for e in kernels) / n_calls
    return wall_ms, busy_ms, ops, joint_ms, kernels, peak_gib, base_gib


class FunctionalSteps:
    """An engine's params and cache served by the functional steps
    (``decode_step`` + ``merge_slots``, ``decode_chunk``, ``reset_slots``,
    each returning a new cache) run eagerly: the baseline the engine's
    in-place steps are measured against, whole-cache copies included. The
    cache is the engine's at the start; the engine's own is never
    written."""

    sentinel = None

    def __init__(self, engine, tables):
        from repro_torch.models import (decode_chunk, decode_step,
                                        merge_slots, reset_slots)
        self.cfg = cfg = engine.cfg
        self.device, self.n_slots = engine.device, engine.n_slots
        self.prefill_chunk, self.max_len = engine.prefill_chunk, engine.max_len
        self.params, self.cache = engine.params, engine.cache

        @torch.no_grad()
        def decode(params, cache, token, active):
            lg, new = decode_step(params, cache, token, cfg, tables=tables)
            return lg, merge_slots(new, cache, active, cfg)

        @torch.no_grad()
        def prefill(params, cache, tokens, n_valid):
            return decode_chunk(params, cache, tokens, n_valid, cfg,
                                tables=tables)

        self._decode, self._prefill = decode, prefill
        self._reset = lambda cache, mask: reset_slots(cache, mask, cfg)


def phase_profile_long(engine, tables, out):
    """``phase_profile`` at the long-context serve cell's shape (batch 16,
    a 2048-slot cache, chunks of 256) over the serve phase's params and
    tables: the functional steps, then an engine's in-place steps eagerly,
    then compiled, one engine on the card at a time (the serve phase's two
    engines stay resident)."""
    from repro_torch.serving import ServeEngine
    for label, graphs in (("long functional", False), ("long eager", False),
                          ("long compiled", True)):
        long = ServeEngine(engine.cfg, engine.params, n_slots=LONG_B,
                           max_len=LONG_A, prefill_chunk=LONG_C,
                           stacked_tables=tables, device=engine.device,
                           cuda_graphs=graphs)
        if label.endswith("functional"):
            long = FunctionalSteps(long, tables)
        phase_profile([(label, long)], out=out)
        del long
    return out


def phase_profile(engines, n_steps=8, n_chunks=4, long_fill=4, out=None):
    """For each engine (the functional steps, the eager in-place engine and
    the compiled one, at the serve phase's shape and at the long-context
    cell's), the device
    busy time and idle share over a window of decode calls (all slots
    active) and over a window of prefill-chunk calls (every slot a full
    chunk, from slots reset by the engine's reset step), each call
    through the engine's own steps on its own cache, so no step sees a new
    signature; the joint kernel's share of the busy time, where the device
    time goes, and the window's peak device memory. The long-context
    engines decode from slots reset and filled by ``long_fill`` chunks
    (1024 positions of 2048). For a compiled engine also the device span
    of a decode call (CUDA events around back-to-back calls: the input
    copies and the graph, without the host copy of the logits) and the
    host µs of its input signature. Adds {(engine, call): (wall ms, busy
    ms or None, ops, peak GiB)} to ``out`` and returns it."""
    from repro_torch import obs
    out = {} if out is None else out
    port_symbols = [sym for mod in _kernel_modules().values()
                    for sym in mod.SYMBOLS]
    for label, engine in engines:
        dev = engine.device
        B, C = engine.n_slots, engine.prefill_chunk
        tok = torch.ones((B, 1), dtype=torch.int32, device=dev)
        active = torch.ones((B,), dtype=torch.bool, device=dev)
        chunk = torch.ones((B, C), dtype=torch.int32, device=dev)
        n_valid = torch.full((B,), C, dtype=torch.int32, device=dev)
        every = torch.ones((B,), dtype=torch.bool, device=dev)

        def decode_window(engine=engine, tok=tok, active=active):
            for _ in range(n_steps):
                lg, engine.cache = engine._decode(engine.params, engine.cache,
                                                  tok, active)
                lg.float().cpu()               # the engine's per-tick sync

        def reset_all(engine=engine, every=every):
            engine.cache = engine._reset(engine.cache, every)

        def prefill_window(engine=engine, chunk=chunk, n_valid=n_valid,
                           n=n_chunks):
            for _ in range(n):
                lg, engine.cache = engine._prefill(engine.params,
                                                   engine.cache, chunk,
                                                   n_valid)
                lg[:, 0].float().cpu()         # the engine's per-call sync

        def filled(reset_all=reset_all, prefill_window=prefill_window):
            reset_all()
            prefill_window(n=long_fill)

        long_cell = label.startswith("long")
        cfg = engine.cfg
        windows = [("decode call", decode_window, n_steps, B,
                    filled if long_cell else None, obs.per_call(cfg))]
        if engine._prefill is not None:       # none in "full" prefill mode
            windows.append(("prefill-chunk call", prefill_window, n_chunks,
                            B * C, reset_all,
                            obs.per_call(cfg, C if cfg.prefill_exact else 1)))
        for what, window, n, rows, setup, per_call in windows:
            wall_ms, busy_ms, ops, joint_ms, kernels, peak, base = \
                _profile_window(window, n, per_call, setup)
            out[(label, what)] = (wall_ms, busy_ms, ops, peak)
            if busy_ms is None:
                other = out.get((label.replace("compiled", "eager"), what))
                log(f"[profile] {label} {what}: {wall_ms:.2f} ms wall, peak "
                    f"device memory {peak:.3f} GiB ({base:.3f} GiB resident "
                    f"before the window); busy not measured: torch.profiler "
                    f"kept no whole record of this window" + (
                        "" if other is None or other[1] is None else
                        f" (inside CUDA graph replays); the eager window's "
                        f"busy {other[1]:.3f} ms beside this wall"))
                continue
            torch_ms = sum(e.self_device_time_total for e in kernels
                           if not any(sym in e.key for sym in port_symbols)
                           ) / 1e3 / n
            log(f"[profile] {label} {what} (batch {B}, {rows} rows per "
                f"projection, {engine.max_len}-slot cache, {n} calls): "
                f"{wall_ms:.3f} ms wall, device busy "
                f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}; "
                f"{ops:.0f} device ops per call; joint kernel "
                f"{joint_ms:.3f} ms/call, {joint_ms / busy_ms:.1%} of busy; "
                f"torch's ops (all but the port's kernels: SSD math, "
                f"elementwise ops, copies, the unembedding) {torch_ms:.3f} "
                f"ms/call, {torch_ms / busy_ms:.1%} of busy; "
                f"peak device memory {peak:.3f} GiB ({base:.3f} GiB "
                f"resident before the window)")
            for e in sorted(kernels,
                            key=lambda e: -e.self_device_time_total)[:8]:
                ms = e.self_device_time_total / 1e3 / n
                log(f"[profile]   {ms:.3f} ms/call ({ms / busy_ms:.1%} of "
                    f"busy), {e.count / n:.0f}/call: {e.key[:100]}")
        if getattr(engine._decode, "graphs", False):
            if long_cell:
                filled()

            def decode_calls(engine=engine, tok=tok, active=active):
                engine._decode(engine.params, engine.cache, tok, active)

            span_ms = _time(decode_calls, iters=n_steps, warmup=1)
            args = (engine.params, engine.cache, tok, active)
            sig_us = _host_us(lambda: engine._decode._signature(args),
                              iters=200)
            # one synced call at a time, as the engine ticks: the host time
            # until the call returns (signature, input copies, graph
            # launch), then until the logits are on the host
            issue = finish = 0.0
            for _ in range(n_steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, _ = engine._decode(engine.params, engine.cache, tok,
                                       active)
                t1 = time.perf_counter()
                lg.float().cpu()
                issue += t1 - t0
                finish += time.perf_counter() - t1
            log(f"[profile] {label} decode call: device span "
                f"{span_ms:.3f} ms per call (CUDA events around "
                f"{n_steps} back-to-back calls: input copies and graph "
                f"replay, no host copy); its input signature "
                f"{sig_us:.1f} µs of host time per call; one synced call: "
                f"{1e3 * issue / n_steps:.3f} ms until it returns, then "
                f"{1e3 * finish / n_steps:.3f} ms until its logits are on "
                f"the host")
    for label, engine in engines:
        if engine.sentinel is not None:
            assert all(n == 1 for n in engine.sentinel.counts().values()), \
                (label, engine.sentinel.counts())
    return out


def _time(fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_auto(fn, budget_s=0.2):
    """Mean ms per call with CUDA events after warm-up, over as many calls
    as fit in about ``budget_s`` (at least 3, at most 200)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    once = max(time.monotonic() - t0, 1e-6)
    iters = int(min(200, max(3, budget_s / once)))
    return _time(fn, iters=iters, warmup=min(iters, 5))


def _host_us(fn, iters=20, windows=7):
    """Host µs per call: the time to issue ``iters`` back-to-back calls,
    read before the device has finished them (the launch queue holds them
    all), so the wrapper's and the launch's host work alone; the fastest of
    ``windows`` windows, since the host's other work only ever adds."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return 1e6 * best / iters


def _pad():
    """Opens and ends a profiled window: late in a long process the
    profiler drops the records of a window's first and last kernels (on
    an H100: arctic's last dense-MLP launches and final norm, the first 2
    to 4 port launches of every profile window), so 64 spin kernels
    (``torch.cuda._sleep``, ~0.2 ms each) run before the window's own work
    starts and after it has finished. Readings leave their records out
    (``PAD_SYMBOL``). With spins of ~10 µs, two of four counted chaos runs
    of phase 4g lost one or more whole calls' records; with ~0.2 ms, none
    of four (H100 80GB HBM3, 700 W)."""
    torch.cuda.synchronize()
    for _ in range(64):
        torch.cuda._sleep(400000)
    torch.cuda.synchronize()


def _device_records(prof):
    """(device-side records but the pad's, the port's kernel launches
    among them, and those per kernel) of a finished torch.profiler window
    (the block-sparse matmul shares the joint kernel's symbols and counts
    as it)."""
    from torch.autograd import DeviceType

    from repro_torch.obs import device_launches
    recorded = {name: mod for name, mod in _kernel_modules().items()
                if name != "block_sparse_matmul"}
    n = sum(1 for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and PAD_SYMBOL not in e.name())
    per_kernel = device_launches(prof, recorded)
    return n, sum(per_kernel.values()), per_kernel


def _device_events(prof):
    """A finished window's device-side ``key_averages`` entries (kernels,
    copies) with device time, but the pad's: a CPU op's entry also
    carries the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and PAD_SYMBOL not in e.key]


def _device_ms(fn, iters=10, attempts=6, launches=None):
    """Mean device time per call (ms) from torch.profiler's device-side
    records (kernels, copies) over ``iters`` calls after a warm-up call:
    what the card spent, without the wrappers' host time. Late in a long
    process the profiler loses records (a window with none, or with some
    calls' kernels missing, which reads under the bytes bound), so a
    window counts only if it is whole: ``iters`` x as many records as the
    most one call showed in three windows of its own, and, given
    ``launches`` (the port's kernel launches a call), ``iters`` x that
    many port-kernel records. Up to ``attempts`` windows are taken; None
    if none is whole."""
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _pad()
            for _ in range(n):
                fn()
            _pad()
        return prof

    fn()
    torch.cuda.synchronize()
    per_call = max(_device_records(window(1))[0] for _ in range(3))
    seen = []
    for _ in range(attempts):
        prof = window(iters)
        records, port, _ = _device_records(prof)
        if per_call and records == iters * per_call and (
                launches is None or port == iters * launches):
            us = sum(e.self_device_time_total for e in _device_events(prof))
            return us / 1e3 / iters
        seen.append((records, port))
    log(f"[times]   no whole window: (records, port launches) {seen}, "
        f"want ({iters * per_call}, "
        f"{'any' if launches is None else iters * launches})")
    return None


def _bound(nbytes, ops, peak_ops):
    """(bound ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _joint_case(name, K, N, p, rows, repeat, gen, dev):
    """One joint launch of ``rows`` bf16 rows against pack ``p``, repeated
    ``repeat`` times in its unit (once per layer): bytes are x, the payload
    as stored, idx, scales and the (rows, NT * bn) output once each;
    operations 2 per stored weight and row."""
    from repro_torch.kernels import joint_sparse_matmul as jsm
    from repro_torch.kernels import ops
    bf16 = torch.bfloat16
    w_dense = ops.unpack_joint_sparse(p).to(bf16)
    stored = p.w_blocks.numel()
    nt, maxb, _, bn = p.w_blocks.shape
    x = torch.randn((rows, K), generator=gen).to(bf16).to(dev)
    return dict(
        name=name, K=K, N=N, NT=nt, MAXB=maxb,
        kernel=lambda x=x, p=p: jsm.joint_sparse_matmul(
            x, p.w_blocks, p.idx, p.scales),
        plain=lambda x=x, p=p: jsm.joint_sparse_matmul_plain(
            x, p.w_blocks, p.idx, p.scales),
        library=lambda x=x, w=w_dense: torch.matmul(x, w),
        bytes=(x.numel() * 2 + stored + p.idx.numel() * 4
               + p.scales.numel() * 4 + rows * nt * bn * 2),
        ops=2 * rows * stored, peak=BF16_FLOPS, repeat=repeat)


def _time_cases(cfg, packs, tables_by_mode, dev, ssm_cfg, ssm_packs,
                moe_cfg, moe_packs, seg, fwd, dense, n_slots=4, M=256):
    """Per work unit, one case per launch: the kernel, its plain version
    and the library call as closures, with the bytes and operations the
    launch needs. The joint kernel at the decode shapes (M = n_slots) and,
    as units of their own, at the JOINT_PREFILL_M rows, and at mamba2's
    two projections (JOINT_SSM_UNITS), and at mixtral's expert shapes
    (JOINT_MOE_UNIT: one decode call's 768 expert launches at its
    capacity of 8 rows), at jamba's (one decode call, 888 launches) and
    at whisper's cross-attention k/v over 4 x 1,500 encoder rows (``seg``:
    jamba's and whisper's configs and packs), and at pixtral's prefill
    call (M = 1,024) and decode step (``fwd``: pixtral's config and
    packs), and at gemma-7b's decode step (``dense``: its config and
    packs); row_attention also at the whisper encoder's shape, at
    pixtral's forward call, at the windowed streaming case and at gemma's
    decode call (hd 256, group 1); the
    block-sparse and FTA/INT8 kernels over phase
    5's layer tables and the DBMU kernel over the four projection shapes
    (M rows); row_norm also at mamba2's gated norm (d = 4096)."""
    from repro_torch.core import dyadic, pruning
    from repro_torch.kernels import block_sparse_matmul as bsk
    from repro_torch.kernels import dbmu_sim
    from repro_torch.kernels import fta_int8_matmul as ftk
    from repro_torch.kernels import ops
    gen = torch.Generator().manual_seed(3)
    bf16 = torch.bfloat16
    cases = {name: [] for name in KERNELS}
    joint_units = {"joint_sparse_matmul": n_slots,
                   **{f"{JOINT_UNIT} M={m}": m for m in JOINT_PREFILL_M}}
    cases.update({unit: [] for unit in joint_units})
    for name, K, N in _path_shapes(cfg):
        p = packs[(K, N)]
        for unit, rows in joint_units.items():
            cases[unit].append(_joint_case(name, K, N, p, rows, cfg.n_layers,
                                           gen, dev))
        x = torch.randn((M, K), generator=gen).to(bf16).to(dev)
        t = tables_by_mode["value"][name]
        wb, idx, w_dense = t["w_blocks"].to(bf16), t["idx"], t["w"].to(bf16)
        stored = wb.numel()
        cases["block_sparse_matmul"].append(dict(
            name=name, K=K, N=N, NT=wb.shape[0], MAXB=wb.shape[1],
            kernel=lambda x=x, wb=wb, idx=idx: bsk.block_sparse_matmul(
                x, wb, idx),
            plain=lambda x=x, wb=wb, idx=idx: bsk.block_sparse_matmul_plain(
                x, wb, idx),
            library=lambda x=x, w=w_dense: torch.matmul(x, w),
            bytes=x.numel() * 2 + stored * 2 + idx.numel() * 4 + M * N * 2,
            ops=2 * M * stored, peak=BF16_FLOPS))
        t = tables_by_mode["bit"][name]
        q, sc = t["q"], t["scales"]
        w_deq = (q.float() * sc).to(bf16)
        cases["fta_int8_matmul"].append(dict(
            name=name, K=K, N=N,
            kernel=lambda x=x, q=q, sc=sc: ftk.fta_int8_matmul(x, q, sc),
            plain=lambda x=x, q=q, sc=sc: ftk.fta_int8_matmul_plain(x, q, sc),
            library=lambda x=x, w=w_deq: torch.matmul(x, w),
            bytes=x.numel() * 2 + K * N + N * 4 + M * N * 2,
            ops=2 * M * K * N, peak=BF16_FLOPS))
    for name, K, N in _distinct(_path_shapes(cfg)):
        w = (torch.randn((K, N), generator=gen) * K ** -0.5).to(dev)
        _, _, packed, _ = ops.fta_pack(
            w, pruning.block_prune_mask(w, 0.6, alpha=8))
        x = torch.randint(-128, 128, (M, K), generator=gen,
                          dtype=torch.int32).to(dev)
        x8 = x.to(torch.int8)
        w8 = dyadic.unpack_terms(packed).to(torch.int8)
        cases["dbmu_matmul"].append(dict(
            name=name, K=K, N=N,
            kernel=lambda x=x, p=packed: dbmu_sim.dbmu_matmul(x, p),
            plain=lambda x=x, p=packed: dbmu_sim.dbmu_matmul_plain(x, p),
            library=lambda a=x8, b=w8: torch._int_mm(a, b),
            bytes=x.numel() * 4 + K * N * 2 + M * N * 4,
            ops=2 * M * K * N, peak=INT8_OPS))
    attn = _row_attention_cases(cfg, dev, gen)
    norm = _row_norm_cases(cfg, dev, gen)
    cases["row_attention"] = [c for c in attn
                              if c["name"] not in ("long context",
                                                   "streaming")]
    cases[ATTN_LONG_UNIT] = [c for c in attn if c["name"] == "long context"]
    cases[ATTN_STREAM_UNIT] = [c for c in attn if c["name"] == "streaming"]
    cases["row_norm"] = [c for c in norm if c["K"] != LONG_B * LONG_C]
    cases[NORM_LONG_UNIT] = [c for c in norm if c["K"] == LONG_B * LONG_C]
    for unit, rows in JOINT_SSM_UNITS.items():
        cases[unit] = [_joint_case(name, K, N, ssm_packs[(K, N)], rows,
                                   ssm_cfg.n_layers, gen, dev)
                       for name, K, N in _path_shapes(ssm_cfg)]
    from repro_torch.models.moe import capacity
    cases[JOINT_MOE_UNIT] = [
        _joint_case(name, K, N, moe_packs[(K, N)], capacity(moe_cfg, n_slots),
                    moe_cfg.n_layers * moe_cfg.n_experts, gen, dev)
        for name, K, N in _path_shapes(moe_cfg)[4:]]
    d_in = ssm_cfg.ssm_expand * ssm_cfg.d_model
    cases[NORM_SSM_UNIT] = _row_norm_cases(ssm_cfg, dev, gen, D=d_in,
                                           rows=(4, 256),
                                           repeat=ssm_cfg.n_layers)
    jamba_cfg, jamba_packs, whisper_cfg, whisper_packs = seg
    cases[JOINT_JAMBA_UNIT] = _jamba_decode_cases(jamba_cfg, jamba_packs,
                                                  n_slots, gen, dev)
    d = whisper_cfg.d_model
    cases[JOINT_XATTN_UNIT] = [
        _joint_case(name, d, d, whisper_packs[(d, d)],
                    n_slots * whisper_cfg.encoder_seq,
                    whisper_cfg.n_layers, gen, dev)
        for name in ("xattn/wk", "xattn/wv")]
    cases[ATTN_ENCODER_UNIT] = [_encoder_attention_case(whisper_cfg, dev,
                                                        gen, n_slots)]
    px_cfg, px_packs = fwd
    for unit, rows in ((JOINT_PIXTRAL_PREFILL_UNIT,
                        PIXTRAL_BATCH * (px_cfg.n_patches + PIXTRAL_TOKENS)),
                       (JOINT_PIXTRAL_DECODE_UNIT, n_slots)):
        cases[unit] = [_joint_case(name, K, N, px_packs[(K, N)], rows,
                                   px_cfg.n_layers, gen, dev)
                       for name, K, N in _path_shapes(px_cfg)]
    cases[ATTN_FWD_UNIT], cases[ATTN_WINDOW_UNIT] = \
        _forward_attention_cases(px_cfg, moe_cfg, dev, gen)
    g_cfg, g_packs = dense
    cases[JOINT_GEMMA_DECODE_UNIT] = [
        _joint_case(name, K, N, g_packs[(K, N)], n_slots, g_cfg.n_layers,
                    gen, dev) for name, K, N in _path_shapes(g_cfg)]
    cases[ATTN_GEMMA_DECODE_UNIT] = _row_attention_cases(g_cfg, dev, gen,
                                                         ("decode",))
    return cases


def _forward_attention_cases(cfg, moe_cfg, dev, gen):
    """row_attention at pixtral's forward call (2 x 512 causal queries
    over their own 512 keys, 40 layers) with SDPA (is_causal) beside it,
    and at the windowed streaming case (one slot, 64 queries at the end
    of 32,768 keys, mixtral's window of 4,096, its 32 layers) with SDPA
    under an explicit mask beside it. Bytes: q, the output and the
    positions once, and each slot's K/V rows that some query reaches
    once; operations: 4 * hd per live key and query head."""
    import torch.nn.functional as F
    from repro_torch.kernels import row_attention as rak
    out = []
    S = cfg.n_patches + PIXTRAL_TOKENS
    for c, B, A, Sq, window in (
            (cfg, PIXTRAL_BATCH, S, S, cfg.window),
            (moe_cfg, 1, STREAM_A_BF16, STREAM_C, moe_cfg.window)):
        q, k, v, pos = _window_inputs(c, dev, torch.bfloat16, gen, B, A, Sq)
        Hkv, hd = c.n_kv_heads, c.hd
        rep = c.n_heads // Hkv
        qh = q.transpose(1, 2)
        kh = torch.repeat_interleave(k, rep, dim=2).transpose(1, 2)
        vh = torch.repeat_interleave(v, rep, dim=2).transpose(1, 2)
        kpos = torch.arange(A, device=dev)[None, None]
        live = kpos <= pos[:, :, None]
        if window:
            live &= kpos > pos[:, :, None] - window
        reached = int(live.any(dim=1).sum())          # K/V rows read
        if window:
            mask = live[:, None]

            def library(qh=qh, kh=kh, vh=vh, mask=mask):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)
        else:
            def library(qh=qh, kh=kh, vh=vh):
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
        out.append([dict(
            name="windowed streaming" if window else "forward",
            K=tuple(q.shape), N=tuple(k.shape),
            kernel=lambda q=q, k=k, v=v, pos=pos, w=window: rak.row_attention(
                q, k, v, pos, w),
            plain=lambda q=q, k=k, v=v, pos=pos, w=window:
                rak.row_attention_plain(q, k, v, pos, w),
            library=library,
            bytes=(2 * q.numel() * 2 + pos.numel() * 4
                   + 2 * reached * Hkv * hd * 2),
            ops=4 * hd * c.n_heads * int(live.sum()), peak=BF16_FLOPS,
            repeat=c.n_layers)])
    return out


def _jamba_decode_cases(cfg, packs, n_slots, gen, dev):
    """One jamba decode call's 888 joint launches, one case per projection
    kind and shape: the attention's, the SSM's and the dense MLP's at M =
    n_slots, once per layer of their kind; the experts' at M = capacity
    (8 at batch 4), once per MoE layer and expert."""
    from repro_torch.models.moe import capacity
    from repro_torch.models.segments import (decoder_layout,
                                             packable_projections)
    shapes = {name: (K, N) for name, K, N in _path_shapes(cfg)}
    layers = {}
    for seg in decoder_layout(cfg):
        for name in packable_projections(seg, cfg):
            layers[name] = layers.get(name, 0) + seg.length
    cases = []
    for name, n in layers.items():
        expert = name.startswith("moe/")
        K, N = shapes[name[4:] if expert else name]
        cases.append(_joint_case(
            name, K, N, packs[(K, N)],
            capacity(cfg, n_slots) if expert else n_slots,
            n * cfg.n_experts if expert else n, gen, dev))
    assert sum(c["repeat"] for c in cases) == \
        JAMBA_PER_CALL["joint_sparse_matmul"], cases
    return cases


def _encoder_attention_case(cfg, dev, gen, n_slots):
    """One layer of the whisper encoder's attention (non-causal, every
    query against all encoder_seq keys), repeated over its layers, with
    SDPA (no mask) beside it. Bytes: q, k, v and the output once each and
    the positions; operations: 4 * hd per key and query head."""
    import torch.nn.functional as F
    from repro_torch.kernels import row_attention as rak
    q, k, v, pos = _encoder_attention_inputs(cfg, dev, torch.bfloat16, gen,
                                             cfg.encoder_seq, n_slots)
    B, A, Hkv, hd = k.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        name="encoder", K=tuple(q.shape), N=tuple(k.shape),
        kernel=lambda: rak.row_attention(q, k, v, pos),
        plain=lambda: rak.row_attention_plain(q, k, v, pos),
        library=lambda: F.scaled_dot_product_attention(qh, kh, vh),
        bytes=2 * (2 * q.numel() + 2 * k.numel()) + pos.numel() * 4,
        ops=4 * hd * cfg.n_heads * B * q.shape[1] * A, peak=BF16_FLOPS,
        repeat=cfg.encoder_layers)


def _row_attention_cases(cfg, dev, gen,
                         whats=("decode", "chunk", "long", "stream")):
    """Of ``whats``: a decode call and a prefill-chunk call of one layer's
    attention at the serving shapes, a prefill-chunk call of the
    long-context cell and the streaming case, each repeated over the
    layers. Bytes: the queries, positions and outputs once, and the live
    cache rows of each slot once; operations: 4 * hd per live key and
    query head."""
    import torch.nn.functional as F
    from repro_torch.kernels import row_attention as rak
    inputs = {}
    if {"decode", "chunk"} & set(whats):
        inputs["decode"] = inputs["chunk"] = _serve_attention_inputs(
            cfg, dev, torch.bfloat16, gen)
    if "long" in whats:
        inputs["long"] = _long_attention_inputs(cfg, dev, torch.bfloat16, gen)
    if "stream" in whats:
        inputs["stream"] = _stream_attention_inputs(cfg, dev, torch.bfloat16,
                                                    gen, STREAM_A_BF16)
    cases = []
    for what in whats:
        a = inputs[what]
        k, v = a["k"], a["v"]
        B, A, Hkv, hd = k.shape
        rep = cfg.n_heads // Hkv
        kh = torch.repeat_interleave(k, rep, dim=2).transpose(1, 2)
        vh = torch.repeat_interleave(v, rep, dim=2).transpose(1, 2)
        q, pos = a[what]
        live = torch.clamp(pos.long(), max=A - 1) + 1               # (B, Sq)
        mask = (torch.arange(A, device=dev)[None, None] <
                live[:, :, None])[:, None]                          # (B,1,Sq,A)
        qh = q.transpose(1, 2)
        cases.append(dict(
            name={"long": "long context", "stream": "streaming"}.get(what,
                                                                    what),
            K=tuple(q.shape), N=tuple(k.shape),
            kernel=lambda q=q, pos=pos, k=k, v=v: rak.row_attention(
                q, k, v, pos),
            plain=lambda q=q, pos=pos, k=k, v=v: rak.row_attention_plain(
                q, k, v, pos),
            library=lambda qh=qh, mask=mask, kh=kh, vh=vh:
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            bytes=(2 * q.numel() * 2 + pos.numel() * 4
                   + 2 * int(live.max(dim=1).values.sum()) * Hkv * hd * 2),
            ops=4 * hd * cfg.n_heads * int(live.sum()), peak=BF16_FLOPS,
            repeat=cfg.n_layers))
    return cases


def _row_norm_cases(cfg, dev, gen, D=None, rows=(4, 256, LONG_B * LONG_C),
                    repeat=None):
    """The norms of a decode call (4 rows), of a prefill-chunk call (256
    rows) and of a long-context prefill-chunk call (16 x 256 rows), 2 per
    layer and the final one (``repeat``), at d_model (``D``). Bytes: x and
    out once, the scale once; operations: 4 fp32 flops per element."""
    import torch.nn.functional as F
    from repro_torch.kernels import row_norm as rnk
    D = D or cfg.d_model
    repeat = repeat or 2 * cfg.n_layers + 1
    scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(dev)
    scale_bf16 = scale.to(torch.bfloat16)
    cases = []
    for R in rows:
        x = torch.randn((R, D), generator=gen).to(torch.bfloat16).to(dev)
        library = None
        if hasattr(F, "rms_norm"):
            library = (lambda x=x: F.rms_norm(x, (D,), scale_bf16, 1e-6))
        cases.append(dict(
            name=f"{R} rows", K=R, N=D,
            kernel=lambda x=x: rnk.row_norm(x, scale),
            plain=lambda x=x: rnk.row_norm_plain(x, scale),
            library=library,
            bytes=2 * R * D * 2 + D * 4, ops=4 * R * D, peak=FP32_FLOPS,
            repeat=repeat))
    return cases


def phase_times(cfg, packs, tables_by_mode, dev, ssm_cfg, ssm_packs,
                moe_cfg, moe_packs, seg, fwd, dense):
    """Each kernel, its plain version and its library yardstick, launch by
    launch over its work unit, beside the bound; the joint kernel's
    decode-step totals count each projection once per layer. Returns
    {kernel: totals and per-launch rows for the JSON line}."""
    def us(v):
        return "not measured" if v is None else f"{v * 1e3:.1f} us"

    def ms_(v):
        return "n/a" if v is None else f"{v:.4f} ms"

    out = {}
    for kname, rows in _time_cases(cfg, packs, tables_by_mode, dev,
                                   ssm_cfg, ssm_packs, moe_cfg, moe_packs,
                                   seg, fwd, dense).items():
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   library_device_ms=0.0, bytes=0, ops=0, host_us=0.0)
        per_shape = []
        n_launches = 0
        for c in rows:
            repeat = c.get("repeat", 1)
            n_launches += repeat
            ms, plain = _time_auto(c["kernel"]), _time_auto(c["plain"])
            dev_ms = _device_ms(c["kernel"], launches=1)
            host = _host_us(c["kernel"])
            lib = lib_dev = None
            if c["library"]:
                lib, lib_dev = (_time_auto(c["library"]),
                                _device_ms(c["library"], launches=0))
            bound, by = _bound(c["bytes"], c["ops"], c["peak"])
            per_shape.append(dict(
                {k: v for k, v in c.items()
                 if k not in ("kernel", "plain", "library", "peak")},
                ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
                host_us=host))
            for key, val in (("ms", ms), ("device_ms", dev_ms),
                             ("plain_ms", plain), ("library_ms", lib),
                             ("library_device_ms", lib_dev),
                             ("bytes", c["bytes"]), ("ops", c["ops"]),
                             ("host_us", host)):
                tot[key] = None if val is None or tot[key] is None \
                    else tot[key] + repeat * val
            log(f"[times] {kname} {c['name']} {c['K']}x{c['N']}: kernel "
                f"{us(ms)} (device {us(dev_ms)}, host {host:.1f} us), plain "
                f"{us(plain)}, library "
                f"{'n/a' if c['library'] is None else us(lib)} (device "
                f"{'n/a' if c['library'] is None else us(lib_dev)}), bound "
                f"{bound * 1e3:.2f} us ({by}, {c['bytes'] / 1e6:.3f} MB)")
        tot["bound_ms"], tot["bound_by"] = _bound(tot["bytes"], tot["ops"],
                                                  rows[0]["peak"])
        tot["host_us"] /= n_launches             # per launch
        tot["per_shape"] = per_shape
        out[kname] = tot
        log(f"[times] {kname}, {n_launches} launches: kernel "
            f"{ms_(tot['ms'])} (device {ms_(tot['device_ms'])}), plain "
            f"{ms_(tot['plain_ms'])}, library {ms_(tot['library_ms'])} "
            f"(device {ms_(tot['library_device_ms'])}), bound "
            f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}, "
            f"{tot['bytes'] / 1e6:.1f} MB); host {tot['host_us']:.1f} us per "
            f"launch")
    return out


#: phase 9 (train): the train CLI's defaults at tinyllama-1.1b's full width
TRAIN_ARGS = ["--arch", "tinyllama-1.1b", "--batch", "8", "--seq", "128",
              "--log-every", "5"]
TRAIN_STEPS = 20
#: the resume check's depth (full width: 219 M params, a save of bf16
#: params and float32 moments ~2 GiB)
TRAIN_RESUME_LAYERS = 2
TRAIN_RESUME_AT = 10
#: steps of each variant (--int8-opt, --grad-compression, --dbpim-every 2)
TRAIN_VARIANT_STEPS = 4
#: full-width gradients, kernel path against plain path, relative to each
#: leaf's peak: in float32 the two differ only in the row kernels' sum
#: orders; in bf16 each rounds at its own places (the kernels' fp32 logits
#: and probabilities, the plain version's bf16 einsums) in 22 layers,
#: forward and back, so bf16 is a sanity bound and float32 the check
TRAIN_GRAD_F32_TOL = 1e-3
TRAIN_GRAD_BF16_TOL = 1e-1
#: the backward kernels' checks: norm rows, widths (tinyllama's d and the
#: gated norm's), attention layouts (B, S, Hq, Hkv, hd, window)
NORM_BWD_ROWS = 1024
NORM_BWD_WIDTHS = (2048, 4096)
ATTN_BWD_CASES = ((8, 128, 32, 4, 64, 0), (1, 2048, 32, 4, 64, 0),
                  (2, 512, 32, 4, 64, 128))
#: (g) the other families, each at full width: arch -> (--layers, the
#: train CLI's extra flags, launches a step of row_norm and row_attention,
#: forward and backward alike). From the code: a decoder layer runs one
#: norm before its mixer and one before its MLP (models/transformer.py),
#: an SSM layer its pre-norm and the gated norm of models/ssm.py, and the
#: final norm adds one: 2 L + 1 row_norm launches (mamba2 97 at 48 layers,
#: its gated norms at d = 4096; stablelm 49, LayerNorms with a bias);
#: each attention layer one row_attention launch (models/attention.py)
#: and one of each backward kernel (stablelm: hd 64, group 1, partial
#: RoPE; mixtral: hd 128, group 4, the window of 4,096 past seq 128).
#: mixtral at 2 layers holds 3.16 B params (1.41 B of experts a layer), so
#: it trains with the INT8 optimizer state
TRAIN_FAMILIES = {
    "mamba2-1.3b": (None, [], {"row_norm": 97, "row_attention": 0}),
    "stablelm-1.6b": (None, [], {"row_norm": 49, "row_attention": 24}),
    "mixtral-8x7b": (2, ["--int8-opt"], {"row_norm": 5, "row_attention": 2}),
}
#: the kernels' entries of the JSON line this phase adds
BWD_KERNELS = ("row_norm_bwd", "row_attention_bwd_dq",
               "row_attention_bwd_dkv")


def _bwd_counters():
    """name -> (module, counter attribute) of the three backward kernels."""
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    return {"row_norm_bwd": (rnk, "BWD_LAUNCHES"),
            "row_attention_bwd_dq": (rak, "DQ_LAUNCHES"),
            "row_attention_bwd_dkv": (rak, "DKV_LAUNCHES")}


def read_bwd_launches():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _bwd_counters().items()}


def reset_bwd_launches():
    for mod, attr in _bwd_counters().values():
        setattr(mod, attr, 0)


@contextlib.contextmanager
def _plain_calls():
    """Counts the calls of the row kernels' plain versions (forward and
    backward) while it is open: {name: calls}."""
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    calls = {}
    swaps = [(rnk, "row_norm_plain"), (rnk, "row_norm_backward_plain"),
             (rak, "row_attention_plain"),
             (rak, "row_attention_backward_plain")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in swaps]
    for mod, attr, fn in saved:
        calls[attr] = 0

        def counted(*a, _fn=fn, _attr=attr, **kw):
            calls[_attr] += 1
            return _fn(*a, **kw)
        setattr(mod, attr, counted)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _gap(got, want):
    """max |got - want| over max |want| (0 for an all-zero want)."""
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    return err / peak if peak else err, err


def _check_norm_backward(dev, gen):
    """row_norm's backward kernels against autograd of the plain version:
    RMSNorm, LayerNorm and (1 + w) RMSNorm at d = 2048 and 4096 over 1,024
    rows, bf16 and f32; dx within 1e-5 of its peak (f32) or one bf16 ulp
    of it, dscale and dbias (float32 sums) within 1e-5 of theirs; a second
    launch gives the same bits. Returns the largest absolute error."""
    from repro_torch.kernels import row_norm as rnk
    worst = 0.0
    for D in NORM_BWD_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((NORM_BWD_ROWS, D), generator=gen).to(dtype).to(dev)
            dy = torch.randn((NORM_BWD_ROWS, D), generator=gen).to(dtype).to(dev)
            scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(dev)
            bias = (0.1 * torch.randn((D,), generator=gen)).to(dev)
            for kind, b, plus_one in (("rms", None, False),
                                      ("layernorm", bias, False),
                                      ("plus_one", None, True)):
                got = rnk.row_norm_backward(dy, x, scale, b,
                                            plus_one=plus_one)
                again = rnk.row_norm_backward(dy, x, scale, b,
                                              plus_one=plus_one)
                want = rnk.row_norm_backward_plain(dy, x, scale, b,
                                                   plus_one=plus_one)
                torch.cuda.synchronize()
                gaps = []
                for i, (g, a, w) in enumerate(zip(got, again, want)):
                    if w is None:
                        assert g is None
                        continue
                    assert torch.equal(g, a), (kind, D, dtype, i)
                    rel, err = _gap(g, w)
                    peak = w.float().abs().max().item()
                    tol = (_bf16_ulp(peak) / peak
                           if i == 0 and dtype == torch.bfloat16 else 1e-5)
                    assert rel <= tol, (kind, D, dtype, i, rel, tol)
                    worst = max(worst, err)
                    gaps.append(rel)
                log(f"[train] row_norm backward {kind} d={D} "
                    f"{str(dtype)[6:]}: dx, dscale"
                    f"{', dbias' if b is not None else ''} within "
                    + ", ".join(f"{g:.2e}" for g in gaps)
                    + " of their peaks; bitwise repeatable")
    return worst


def _attn_bwd_inputs(case, dtype, dev, gen):
    B, S, Hq, Hkv, hd, window = case
    q, dout = (torch.randn((B, S, Hq, hd), generator=gen).to(dtype).to(dev)
               for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, hd), generator=gen).to(dtype).to(dev)
            for _ in range(2))
    qpos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    return q, k, v, qpos, dout, window


def _check_attention_backward(dev, gen):
    """row_attention's two backward kernels against autograd of the plain
    version on causal self-attention (query i at position i over the
    sequence's own keys): tinyllama's training layout (B 8, S 128, 32 / 4
    heads of 64), one long sequence (B 1, S 2048) and a window of 128 at
    S 512; bf16 and f32; dq, dk, dv within 1e-5 of each peak (f32) or
    2^-6 of it (bf16: the plain version rounds its logits, probabilities
    and their gradients to bf16); a second launch gives the same bits.
    Returns the largest absolute errors of (a) (dq) and (b) (dk, dv)."""
    from repro_torch.kernels import row_attention as rak
    worst = [0.0, 0.0]
    for case in ATTN_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, qpos, dout, window = _attn_bwd_inputs(case, dtype, dev,
                                                           gen)
            out = rak.row_attention(q, k, v, qpos, window)
            got = rak.row_attention_backward(dout, q, k, v, qpos, out, window)
            again = rak.row_attention_backward(dout, q, k, v, qpos, out,
                                               window)
            want = rak.row_attention_backward_plain(dout, q, k, v, qpos,
                                                    window)
            torch.cuda.synchronize()
            tol = ATTN_REL_TOL if dtype == torch.bfloat16 else 1e-5
            gaps = []
            for i, (g, a, w) in enumerate(zip(got, again, want)):
                assert torch.equal(g, a), (case, dtype, i)
                rel, err = _gap(g, w)
                assert rel <= tol, (case, dtype, "qkv"[i], rel, tol)
                worst[min(i, 1)] = max(worst[min(i, 1)], err)
                gaps.append(rel)
            log(f"[train] row_attention backward B={case[0]} S={case[1]} "
                f"heads {case[2]}/{case[3]} hd={case[4]} window={case[5]} "
                f"{str(dtype)[6:]}: dq, dk, dv within "
                + ", ".join(f"{g:.2e}" for g in gaps)
                + f" of their peaks (tol {tol:.2e}); bitwise repeatable")
            del q, k, v, dout, out, got, again, want
    return worst


def _full_width_grads(cfg, params, batch, plain):
    """(loss, {leaf: gradient}) of one loss_fn call and its backward on
    trainable copies of ``params``, through the kernels or (``plain``)
    their plain versions."""
    from repro_torch.launch.steps import trainable
    from repro_torch.models import loss_fn
    tp = trainable(params)
    with plain_versions() if plain else contextlib.nullcontext():
        loss = loss_fn(tp, batch, cfg)
        loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: t.grad for k, t in _flat(tp).items()}


def _check_full_width_step(dev, arch="tinyllama-1.1b", layers=None,
                           per_step=None):
    """(b): one step at the CLI's defaults (batch 8, seq 128) of
    ``arch`` at full width (``layers`` deep, default its depth), bf16 and
    a float32 copy: every gradient leaf of the kernel path (``per_step``
    launches of row_norm and row_attention forward, as many of row_norm's
    backward and of each attention backward kernel; tinyllama-1.1b's: 45
    and 22) against the plain path's (no launch), from the same params and
    batch; every floating leaf gets a gradient."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import _batch_on
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import tree_map
    cfg = get_config(arch)
    if layers is not None:
        cfg = cfg.scaled(n_layers=layers)
    batch = _batch_on(SyntheticLMDataset(cfg, 8, 128, seed=0).batch_at(0),
                      dev)
    params = init_params(cfg, seed=0, device=dev)
    per_step = per_step or {"row_norm": 2 * cfg.n_layers + 1,
                            "row_attention": cfg.n_layers}
    for name, tol, p in (("bf16", TRAIN_GRAD_BF16_TOL, params),
                         ("f32", TRAIN_GRAD_F32_TOL,
                          tree_map(lambda t: t.float(), params))):
        reset_launches()
        reset_bwd_launches()
        with _routing() as plain_routes:
            loss_p, grads_p = _full_width_grads(cfg, p, batch, plain=True)
        assert not any({**read_launches(), **read_bwd_launches()}.values())
        # an MoE layer's top-k choices replayed from the plain path: each
        # side's own rounding flips near-tied choices, and a flipped token
        # moves its whole contribution to another expert's gradient
        with _routing(plain_routes["idx"]) as routes:
            loss_k, grads_k = _full_width_grads(cfg, p, batch, plain=False)
        counts = {**read_launches(), **read_bwd_launches()}
        want = {"row_norm": per_step["row_norm"],
                "row_attention": per_step["row_attention"],
                "row_norm_bwd": per_step["row_norm"],
                "row_attention_bwd_dq": per_step["row_attention"],
                "row_attention_bwd_dkv": per_step["row_attention"]}
        assert {k: counts[k] for k in want} == want, counts
        assert counts["joint_sparse_matmul"] == 0
        assert set(grads_k) == set(grads_p)
        worst_leaf, worst = None, 0.0
        for key, g in grads_k.items():
            w = grads_p[key]
            assert g is not None and w is not None, key
            rel, _ = _gap(g, w)
            if rel >= worst:
                worst_leaf, worst = key, rel
            assert rel <= tol, (name, key, rel, tol)
        log(f"[train] (b) {arch} ({cfg.n_layers} layers) full-width step "
            f"{name}: loss kernel {loss_k:.6f} "
            f"plain {loss_p:.6f}; all {len(grads_k)} gradient leaves within "
            f"{worst:.2e} of their peaks (largest {worst_leaf}; tol {tol}); "
            f"launches a step {want}" + (
                f"; {len(routes['idx'])} routing calls replayed from the "
                f"plain path, {routes['flips']} tokens' own choices differed"
                if routes["idx"] else ""))
        del grads_k, grads_p
        torch.cuda.empty_cache()
    del params


def _train_run(argv):
    from repro_torch.launch import train
    return train.run(train.build_parser().parse_args(argv))


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _train_families(dev):
    """(g): each of TRAIN_FAMILIES at full width: one step's gradients,
    kernel path against plain path (``_check_full_width_step``), then
    TRAIN_VARIANT_STEPS steps of launch.train at the CLI's defaults
    (batch 8, seq 128; the counted main path): finite losses, the
    backward kernels launched steps x the counts a step, forward likewise,
    no joint launch and no plain version called; step p50, tokens/s and
    peak memory. Returns the backward kernels' launches of the runs,
    added."""
    import numpy as np
    total = dict.fromkeys(BWD_KERNELS, 0)
    for arch, (layers, flags, per_step) in TRAIN_FAMILIES.items():
        t0 = time.monotonic()
        _check_full_width_step(dev, arch, layers, per_step)
        torch.cuda.empty_cache()
        depth = [] if layers is None else ["--layers", str(layers)]
        n = TRAIN_VARIANT_STEPS
        reset_launches()
        reset_bwd_launches()
        with _plain_calls() as plain:
            r = _train_run(["--arch", arch, "--batch", "8", "--seq", "128",
                            "--log-every", "5", "--steps", str(n)]
                           + depth + flags)
            torch.cuda.synchronize()
        launches, fwd = read_bwd_launches(), read_launches()
        assert not any(plain.values()), (arch, plain)
        want = {"row_norm_bwd": n * per_step["row_norm"],
                "row_attention_bwd_dq": n * per_step["row_attention"],
                "row_attention_bwd_dkv": n * per_step["row_attention"]}
        assert launches == want, (arch, launches, want)
        assert fwd["row_norm"] == n * per_step["row_norm"] and \
            fwd["row_attention"] == n * per_step["row_attention"] and \
            fwd["joint_sparse_matmul"] == 0, (arch, fwd)
        assert len(r.losses) == n and all(np.isfinite(r.losses)), \
            (arch, r.losses)
        p50 = float(np.median(r.step_s[1:]))
        n_params = sum(t.numel() for t in _flat(r.params).values())
        log(f"[train] (g) {n} steps of launch.train ({arch}, "
            f"{layers or 'all'} layers, {n_params / 1e9:.3f} B params, bf16, "
            f"batch 8 x seq 128{', ' + ' '.join(flags) if flags else ''}): "
            f"losses {', '.join(f'{x:.4f}' for x in r.losses)}; step p50 "
            f"{p50 * 1e3:.2f} ms (first {r.step_s[0] * 1e3:.1f} ms), "
            f"{r.tokens_per_step / p50:.1f} tokens/s, peak "
            f"{r.peak_bytes / 2 ** 30:.3f} GiB; backward launches {launches} "
            f"(forward row_norm {fwd['row_norm']}, row_attention "
            f"{fwd['row_attention']}), no plain version called; "
            f"{time.monotonic() - t0:.1f} s in all; {_smi()}")
        for k in total:
            total[k] += launches[k]
        del r
        torch.cuda.empty_cache()
    return total


def _check_hybrid(dev):
    """(f): the Fig. 4 pipeline on one full-width layer's seven
    projections (layer 0 of a seeded bf16 draw): prune_tree, three
    qat_steps, export_tree and sparsity_report on the card and on the
    host; masks, q, phi_th, scales, packed terms and the report equal."""
    from repro_torch.configs import get_config
    from repro_torch.core import hybrid
    from repro_torch.models import init_params
    cfg = get_config("tinyllama-1.1b").scaled(n_layers=1)
    blocks = init_params(cfg, seed=1, device=dev)["blocks"]
    ws = {f"{a}/{n}": blocks[a][n][0] for a, names in
          (("attn", ("wq", "wk", "wv", "wo")),
           ("mlp", ("w_gate", "w_up", "w_down"))) for n in names}
    hcfg = hybrid.HybridConfig()
    out = {}
    for where, w in (("card", ws), ("host", {k: v.cpu() for k, v in
                                              ws.items()})):
        masks = hybrid.prune_tree(w, hcfg)
        st = {}
        for _ in range(3):
            _, st, _ = hybrid.qat_step(w, masks, st, hcfg)
        ex = hybrid.export_tree(w, masks, st, hcfg)
        out[where] = (masks, ex, hybrid.sparsity_report(ex))
    (cm, cx, crep), (hm, hx, hrep) = out["card"], out["host"]
    for k in ws:
        assert torch.equal(cm[k].cpu(), hm[k]), k
        ce, he = cx[k]["export"], hx[k]["export"]
        for name in ("q", "phi_th", "mask"):
            assert torch.equal(getattr(ce, name).cpu(), getattr(he, name)), k
        assert torch.equal(ce.scale.cpu().view(torch.int32),
                           he.scale.view(torch.int32)), k
        assert torch.equal(cx[k]["packed_terms"].cpu(), hx[k]["packed_terms"])
    assert crep == hrep
    log(f"[train] (f) hybrid on one full-width layer's 7 projections: card "
        f"== host (masks, q, phi_th, scales, packed terms, report); "
        f"compound sparsity "
        + ", ".join(f"{k} {r['compound_sparsity']:.4f}"
                    for k, r in crep.items()))


def phase_train(dev):
    """Phase 9: the training path at tinyllama-1.1b's full width. (a) the
    three backward kernels against their plain versions; (b) one step's
    gradients, kernel path against plain path; (c) 20 steps through
    ``launch.train`` (the counted main path: the backward kernels'
    launches, none of a plain version), step p50, tokens/s and peak
    memory; (d) resume from the checkpoint at step 10 (2 layers) equal to
    the uninterrupted run; (e) the INT8 optimizer, gradient compression
    and the DB-PIM projection in the loop; (f) the hybrid pipeline card ==
    host; (g) ``_train_families``. Returns (the launches of the three
    kernels in (c)'s and (g)'s runs, their largest errors)."""
    import tempfile

    import numpy as np
    t_phase = time.monotonic()
    gen = torch.Generator().manual_seed(11)
    worst = {"row_norm_bwd": _check_norm_backward(dev, gen)}
    worst["row_attention_bwd_dq"], worst["row_attention_bwd_dkv"] = \
        _check_attention_backward(dev, gen)
    torch.cuda.empty_cache()
    _check_full_width_step(dev)
    torch.cuda.empty_cache()

    reset_launches()
    reset_bwd_launches()
    with _plain_calls() as plain:
        r = _train_run(TRAIN_ARGS + ["--steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
    launches = read_bwd_launches()
    fwd = read_launches()
    assert not any(plain.values()), plain
    per_step = {"row_norm_bwd": 45, "row_attention_bwd_dq": 22,
                "row_attention_bwd_dkv": 22}
    assert launches == {k: TRAIN_STEPS * n for k, n in per_step.items()}, \
        launches
    assert fwd["row_norm"] == TRAIN_STEPS * 45 and \
        fwd["row_attention"] == TRAIN_STEPS * 22, fwd
    assert all(np.isfinite(r.losses)) and r.losses[-1] < r.losses[0], r.losses
    p50 = float(np.median(r.step_s[1:]))
    smi = _smi()
    log(f"[train] (c) {TRAIN_STEPS} steps of launch.train (tinyllama-1.1b, "
        f"22 layers, bf16, batch 8 x seq 128): loss {r.losses[0]:.4f} -> "
        f"{r.losses[-1]:.4f}; step p50 {p50 * 1e3:.2f} ms (first "
        f"{r.step_s[0] * 1e3:.1f} ms), {r.tokens_per_step / p50:.1f} "
        f"tokens/s, peak {r.peak_bytes / 2 ** 30:.3f} GiB; launches "
        f"{launches} (and forward row_norm {fwd['row_norm']}, row_attention "
        f"{fwd['row_attention']}), no plain version called; {smi}")
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import build_train_step
    step = build_train_step(get_config("tinyllama-1.1b"))
    batch = SyntheticLMDataset(get_config("tinyllama-1.1b"), 8, 128,
                               seed=0).batch_at(TRAIN_STEPS)
    busy = _device_ms(lambda: step(r.params, r.opt_state, batch), iters=2)
    log(f"[train] (c) a step's device busy time (torch.profiler, 2-step "
        f"windows): "
        + ("not measured" if busy is None else
           f"{busy:.3f} ms of the {p50 * 1e3:.2f} ms p50 wall (unprofiled), "
           f"idle share {1 - busy / (p50 * 1e3):.3f}"))
    del r, step
    torch.cuda.empty_cache()

    base = TRAIN_ARGS + ["--layers", str(TRAIN_RESUME_LAYERS)]
    full = _train_run(base + ["--steps", str(TRAIN_STEPS)]).losses
    with tempfile.TemporaryDirectory() as tmp:
        ck = ["--ckpt-dir", tmp, "--ckpt-every", str(TRAIN_RESUME_AT)]
        first = _train_run(base + ["--steps", str(TRAIN_RESUME_AT)]
                           + ck).losses
        rest = _train_run(base + ["--steps", str(TRAIN_STEPS)] + ck).losses
        size = sum(f.stat().st_size for f in Path(tmp).rglob("*.npy"))
    assert len(first) == TRAIN_RESUME_AT and \
        len(rest) == TRAIN_STEPS - TRAIN_RESUME_AT
    np.testing.assert_allclose(first + rest, full, rtol=1e-5)
    gap = max(abs(a - b) / abs(b) for a, b in zip(first + rest, full))
    log(f"[train] (d) resume at step {TRAIN_RESUME_AT} ({TRAIN_RESUME_LAYERS} "
        f"layers, full width; {size / 2 ** 30:.3f} GiB of checkpoints on "
        f"disk): steps {TRAIN_RESUME_AT}-{TRAIN_STEPS - 1} within "
        f"{gap:.2e} of the uninterrupted run (rtol 1e-5)")
    torch.cuda.empty_cache()

    for flags in (["--int8-opt"], ["--grad-compression"],
                  ["--dbpim-every", "2"]):
        r = _train_run(TRAIN_ARGS + ["--steps", str(TRAIN_VARIANT_STEPS)]
                       + flags)
        assert all(np.isfinite(r.losses)), (flags, r.losses)
        note = ""
        if flags[0] == "--int8-opt":
            m = r.opt_state.m["blocks"]["mlp"]["w_up"]
            v = r.opt_state.v["blocks"]["mlp"]["w_up"]
            assert m["q"].dtype == torch.int8 and "sqrt" in v and \
                m["q"].device.type == "cuda"
            note = f", INT8 moments (w_up: q {tuple(m['q'].shape)})"
        log(f"[train] (e) {' '.join(flags)}: {TRAIN_VARIANT_STEPS} steps, "
            f"losses {', '.join(f'{x:.4f}' for x in r.losses)}{note}; peak "
            f"{r.peak_bytes / 2 ** 30:.3f} GiB")
        del r
        torch.cuda.empty_cache()
    _check_hybrid(dev)
    torch.cuda.empty_cache()
    for k, n in _train_families(dev).items():
        launches[k] += n
    log(f"[train] phase 9 took {time.monotonic() - t_phase:.1f} s")
    return launches, worst


def _dkv_alone(q, k, v, qpos, out, dout):
    """A call that launches row_attention's backward kernel (b) alone,
    through its C entry point, on the rows' lse and D from one launch of
    kernel (a) made here: the wrapper always launches (a) first. The call
    holds every tensor it hands the kernel; its dk and dv are first held
    bitwise to the wrapper's."""
    from repro_torch.kernels import row_attention as rak
    B, S, Hq, hd = q.shape
    qpos = qpos.to(torch.int32).contiguous()
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    delta, dq = torch.empty_like(lse), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dims = (B, S, Hq, k.shape[2], k.shape[1], hd, 0, k.stride(0),
            v.stride(0), hd ** -0.5, 1 if q.dtype == torch.bfloat16 else 0)
    lib = rak._library()

    def launch(entry, *ts):
        rc = getattr(lib, entry)(*(t.data_ptr() for t in ts), *dims,
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
    launch("row_attention_bwd_dq_launch", q, k, v, qpos, out, dout, dq, lse,
           delta)

    def run():
        launch("row_attention_bwd_dkv_launch", q, k, v, qpos, dout, lse,
               delta, dk, dv)
    run()
    want = rak.row_attention_backward(dout, q, k, v, qpos, out)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    return run


def _bwd_times(dev):
    """The three backward kernels per launch at tinyllama's training
    shapes, with their plain versions (autograd of the plain forward, so
    also its forward) and the library yardsticks (the backward of
    F.rms_norm, and of F.scaled_dot_product_attention with is_causal and
    GQA, which computes dq, dk and dv in one call), beside their bounds;
    the work unit is one training step's launches (45 row_norm, 22 of
    each attention kernel). Kernel (b) is timed alone through its C entry
    point (``_dkv_alone``): the wrapper's backward less kernel (a) is, at
    these times, mostly the wrappers' host time. Returns {name: the JSON
    entry's numbers}."""
    import torch.nn.functional as F
    from repro_torch.kernels import row_attention as rak
    from repro_torch.kernels import row_norm as rnk
    gen = torch.Generator().manual_seed(12)
    R, D = 8 * 128, 2048
    x = torch.randn((R, D), generator=gen).to(torch.bfloat16).to(dev)
    dy = torch.randn((R, D), generator=gen).to(torch.bfloat16).to(dev)
    scale = (1 + 0.1 * torch.randn((D,), generator=gen)).to(dev)
    xr = x.clone().requires_grad_()
    wr = scale.to(torch.bfloat16).requires_grad_()
    lib_out = F.rms_norm(xr, (D,), wr, 1e-6) if hasattr(F, "rms_norm") \
        else None
    case = ATTN_BWD_CASES[0]
    B, S, Hq, Hkv, hd, _ = case
    q, k, v, qpos, dout, _ = _attn_bwd_inputs(case, torch.bfloat16, dev, gen)
    out = rak.row_attention(q, k, v, qpos)
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                          enable_gqa=True)
    douth = dout.transpose(1, 2)
    live = B * Hq * S * (S + 1) // 2
    lse_bytes = 2 * B * Hq * S * 4
    units = {
        "row_norm_bwd": dict(
            kernel=lambda: rnk.row_norm_backward(dy, x, scale),
            plain=lambda: rnk.row_norm_backward_plain(dy, x, scale),
            library=None if lib_out is None else (
                lambda: torch.autograd.grad(lib_out, (xr, wr), dy,
                                            retain_graph=True)),
            bytes=3 * R * D * 2 + 2 * D * 4, ops=10 * R * D,
            peak=FP32_FLOPS, repeat=2 * 22 + 1,
            work="one training step's norms: 45 launches of 1,024 rows x "
                 "d=2048, bf16"),
        "row_attention_bwd_dq": dict(
            kernel=lambda: rak.row_attention_backward(
                dout, q, k, v, qpos, out, need_kv=False),
            plain=lambda: rak.row_attention_backward_plain(dout, q, k, v,
                                                           qpos),
            library=lambda: torch.autograd.grad(sdpa, (qh, kh, vh), douth,
                                                retain_graph=True),
            bytes=4 * q.numel() * 2 + 2 * k.numel() * 2 + lse_bytes,
            ops=6 * hd * live, peak=BF16_FLOPS, repeat=22,
            work="one training step's kernel (a): 22 launches, batch 8 x "
                 "128 causal queries, 32 / 4 heads of 64, bf16"),
        "row_attention_bwd_dkv": dict(
            kernel=_dkv_alone(q, k, v, qpos, out, dout),
            plain=lambda: rak.row_attention_backward_plain(dout, q, k, v,
                                                           qpos),
            library=lambda: torch.autograd.grad(sdpa, (qh, kh, vh), douth,
                                                retain_graph=True),
            bytes=2 * q.numel() * 2 + 4 * k.numel() * 2 + lse_bytes,
            ops=8 * hd * live, peak=BF16_FLOPS, repeat=22,
            work="one training step's kernel (b): 22 launches, batch 8 x "
                 "128 causal queries, 32 / 4 heads of 64, bf16 (timed alone "
                 "through its C entry point)")}
    res = {}
    for name, u in units.items():
        ms, dev_ms = _time_auto(u["kernel"]), _device_ms(u["kernel"])
        plain = _time_auto(u["plain"])
        lib = lib_dev = None
        if u["library"] is not None:
            lib, lib_dev = _time_auto(u["library"]), _device_ms(u["library"])
        bound, by = _bound(u["bytes"], u["ops"], u["peak"])
        n = u["repeat"]
        res[name] = dict(
            ms=n * ms,
            device_ms=None if dev_ms is None else n * dev_ms,
            plain_ms=n * plain, library_ms=None if lib is None else n * lib,
            library_device_ms=None if lib_dev is None else n * lib_dev,
            bound_ms=n * bound, bound_by=by, work=u["work"])
        log(f"[times] {name}: kernel {ms * 1e3:.1f} us (device "
            f"{'not measured' if dev_ms is None else f'{dev_ms * 1e3:.1f} us'}"
            f"), plain {plain * 1e3:.1f} us, library "
            f"{'n/a' if lib is None else f'{lib * 1e3:.1f} us'} (device "
            f"{'n/a' if lib_dev is None else f'{lib_dev * 1e3:.1f} us'}), "
            f"bound {bound * 1e3:.2f} us ({by}) a launch; x{n} a step: "
            f"kernel {n * ms:.4f} ms")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config

    t_start = time.monotonic()
    dev = torch.device("cuda")
    phase_build()
    cfg = get_config("tinyllama-1.1b", dbpim_mode="joint")
    ssm_cfg = get_config("mamba2-1.3b", dbpim_mode="joint")
    moe_cfg = get_config("mixtral-8x7b", dbpim_mode="joint")
    arctic_cfg = get_config("arctic-480b", dbpim_mode="joint").scaled(
        n_layers=ARCTIC_LAYERS)
    jamba_cfg = get_config("jamba-v0.1-52b", dbpim_mode="joint")
    whisper_cfg = get_config("whisper-base", dbpim_mode="joint")
    pixtral_cfg = get_config("pixtral-12b", dbpim_mode="joint")
    dense_cfgs = [get_config(arch, dbpim_mode="joint")
                  for arch in DENSE_PER_CALL]
    qwen3_cfg, gemma_cfg, _ = dense_cfgs
    packs = phase_pack(cfg, dev)
    ssm_packs = phase_pack(ssm_cfg, dev)
    moe_packs = phase_pack(moe_cfg, dev)
    arctic_packs = phase_pack(arctic_cfg, dev)
    jamba_packs = phase_pack(jamba_cfg, dev, have=moe_packs)
    whisper_packs = phase_pack(whisper_cfg, dev)
    pixtral_packs = phase_pack(pixtral_cfg, dev)
    # the dense variants: only their shapes no model above has are packed
    # and checked (stablelm's are all tinyllama's)
    seen = {**packs, **moe_packs, **pixtral_packs}
    dense_worst = []
    for c in dense_cfgs:
        c_packs = phase_pack(c, dev, have=seen)
        dense_worst.append(phase_kernel(c, c_packs, dev, have=seen))
        seen.update(c_packs)
        if c is gemma_cfg:
            gemma_packs = c_packs
    del seen
    worst = {"joint_sparse_matmul": max(
                 phase_kernel(cfg, packs, dev),
                 phase_kernel(ssm_cfg, ssm_packs, dev),
                 phase_kernel(moe_cfg, moe_packs, dev, MOE_KERNEL_M),
                 phase_kernel(arctic_cfg, arctic_packs, dev, MOE_KERNEL_M),
                 phase_kernel(jamba_cfg, jamba_packs, dev, MOE_KERNEL_M,
                              have=moe_packs),
                 phase_kernel(whisper_cfg, whisper_packs, dev,
                              WHISPER_KERNEL_M),
                 phase_kernel(pixtral_cfg, pixtral_packs, dev,
                              PIXTRAL_KERNEL_M), *dense_worst),
             **phase_kernel_value_bit_dbmu(cfg, dev)}
    del arctic_packs
    worst.update(phase_kernel_rows(
        cfg, dev, (cfg.d_model, ssm_cfg.ssm_expand * ssm_cfg.d_model,
                   whisper_cfg.d_model,
                   jamba_cfg.ssm_expand * jamba_cfg.d_model,
                   gemma_cfg.d_model, qwen3_cfg.hd)))
    worst["row_attention"] = max(worst["row_attention"],
                                 phase_seg_kernel_rows(jamba_cfg,
                                                       whisper_cfg,
                                                       dense_cfgs, dev),
                                 phase_kernel_window(pixtral_cfg, dev))
    # every counted serve run comes before the profile phase, the small
    # ones first: late in a process that has run many profiled windows
    # and counted runs (mixtral's records ~2 M kernels), the profiler has
    # dropped device records of a counted run (arctic's, then
    # tinyllama's); the serve phases' engines stay resident for phase 7
    serve_launches, engine, eager, tables = phase_serve(dev)
    mesh_launches = phase_mesh(dev, eager, tables)
    ssm_launches, ssm_engine, ssm_eager, ssm_tables = phase_serve(
        dev, SSM_SERVE_ARGS, "prefill_parallel")
    phase_ssm_exact(ssm_engine, ssm_tables)
    admit_launches = phase_admission(engine, tables, ssm_engine, ssm_tables)
    dur_launches = phase_durability(engine, tables, ssm_engine, ssm_tables)
    phase_moe_pack(dev)
    moe_launches = phase_moe_serve(dev)
    torch.cuda.empty_cache()
    phase_ring(dev)
    arctic_launches = phase_arctic(dev)
    torch.cuda.empty_cache()
    phase_seg_pack(jamba_cfg, dev)
    jamba_launches = phase_jamba(dev)
    torch.cuda.empty_cache()
    whisper_launches = phase_whisper(dev)
    torch.cuda.empty_cache()
    pixtral_launches = phase_pixtral(dev)
    torch.cuda.empty_cache()
    dense_launches = phase_dense_variants(dev)
    fwd_launches = [family_forward(engine, tables, "fwd"),
                    family_forward(ssm_engine, ssm_tables, "fwd"),
                    phase_window_forward(dev)]
    torch.cuda.empty_cache()
    mode_launches, tables_by_mode = phase_modes(dev)
    torch.cuda.empty_cache()
    comp_launches = phase_compression(dev)
    torch.cuda.empty_cache()
    launches = {k: n + mesh_launches[k] + ssm_launches[k] + moe_launches[k]
                + arctic_launches[k]
                + jamba_launches[k] + whisper_launches[k]
                + pixtral_launches[k] + dense_launches[k]
                + admit_launches[k] + dur_launches[k]
                + comp_launches[k]
                + sum(f[k] for f in fwd_launches)
                for k, n in serve_launches.items()}
    launches.update(mode_launches, dbmu_matmul=phase_dbmu(cfg, dev))
    paper_launches, paper_worst, paper_times = phase_paper(dev)
    launches["joint_sparse_matmul"] += paper_launches
    worst["joint_sparse_matmul"] = max(worst["joint_sparse_matmul"],
                                       paper_worst)
    torch.cuda.empty_cache()
    phase_profile_long(engine, tables, phase_profile(
        [("functional", FunctionalSteps(eager, tables)), ("eager", eager),
         ("compiled", engine), ("mamba2 eager", ssm_eager),
         ("mamba2 compiled", ssm_engine)]))
    del engine, eager, tables, ssm_engine, ssm_eager, ssm_tables
    torch.cuda.empty_cache()
    times = phase_times(cfg, packs, tables_by_mode, dev, ssm_cfg, ssm_packs,
                        moe_cfg, moe_packs,
                        (jamba_cfg, jamba_packs, whisper_cfg, whisper_packs),
                        (pixtral_cfg, pixtral_packs),
                        (gemma_cfg, gemma_packs))
    times[JOINT_PAPER_UNIT] = paper_times

    train_launches, train_worst = phase_train(dev)
    bwd_times = _bwd_times(dev)

    kernels = []
    for name, replaces, work in (
            ("joint_sparse_matmul", "kernels/joint_sparse_matmul.py:129",
             "one tinyllama decode step: 22 layers x 7 projections, M=4, "
             "bf16"),
            ("block_sparse_matmul", "kernels/block_sparse_matmul.py:73",
             "one full-width layer: 7 projections, M=256, bf16, vs=0.6"),
            ("fta_int8_matmul", "kernels/fta_int8_matmul.py:68",
             "one full-width layer: 7 projections, M=256, bf16 x, int8 W"),
            ("dbmu_matmul", "kernels/dbmu_sim.py:74",
             "the four projection shapes, M=256, int8-range x"),
            ("row_attention", "models/attention.py:48",
             "one decode call and one 64-token prefill-chunk call: 22 "
             "launches each, batch 4, 512-slot cache, bf16 (replaces plain "
             "jnp einsums, no TPU kernel)"),
            ("row_norm", "models/layers.py:33",
             "one decode call (4 rows) and one prefill-chunk call (256 "
             "rows): 45 launches each, d=2048, bf16 (replaces plain jnp, no "
             "TPU kernel)")):
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/{replaces}",
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "host_us": t["host_us"], "work": work,
            "per_shape": t["per_shape"]})
        units = {"joint_sparse_matmul": [
            (f"one prefill call: 22 layers x 7 projections, M={m}, bf16",
             f"{JOINT_UNIT} M={m}") for m in JOINT_PREFILL_M] + [
            ("one mamba2 decode step: 48 layers x 2 projections, M=4, bf16",
             "joint_sparse_matmul mamba2 decode"),
            ("one mamba2 prefill call: 48 layers x 2 projections, M=256, "
             "bf16", "joint_sparse_matmul mamba2 prefill"),
            ("one mixtral-8x7b decode call's expert launches: 32 layers x "
             "3 projections x 8 experts, M=8 (an expert's capacity at "
             "batch 4), bf16", JOINT_MOE_UNIT),
            ("one jamba-v0.1-52b decode call: 888 launches (16 x 16 x 3 "
             "experts at M=8, 16 x 3 dense MLP, 28 x 2 SSM and 4 x 4 "
             "attention at M=4), bf16", JOINT_JAMBA_UNIT),
            ("whisper-base's cross-attention K/V of one decode call: 6 "
             "layers x (xattn/wk, xattn/wv), M=6000 (4 slots x 1500 "
             "encoder rows), bf16", JOINT_XATTN_UNIT),
            ("one pixtral-12b prefill call: 40 layers x 7 projections, "
             "M=1024 (2 rows x (256 patches + 256 tokens)), bf16",
             JOINT_PIXTRAL_PREFILL_UNIT),
            ("one pixtral-12b decode step: 40 layers x 7 projections, M=4, "
             "bf16", JOINT_PIXTRAL_DECODE_UNIT),
            ("one gemma-7b decode step: 28 layers x 7 projections, M=4, "
             "bf16", JOINT_GEMMA_DECODE_UNIT),
            ("the paper's six layer shapes (joint_bench_shapes(128): "
             "alexnet.c3, vgg19.conv9, resnet18.s3b0c1, mobilenetv2.head, "
             "efficientnetb0.head, alexnet.fc1), one launch each, M=128, "
             "bf16, tile sparsity 0.5", JOINT_PAPER_UNIT)],
            "row_attention": [
                ("one long-context prefill-chunk call: 22 launches, batch 16 "
                 "x 256 queries, 2048-slot cache, bf16", ATTN_LONG_UNIT),
                ("the streaming path: 22 launches, one slot, 64 queries at "
                 "the end of a 32768-slot cache, bf16", ATTN_STREAM_UNIT),
                ("one whisper-base encoder call: 6 launches, batch 4 x 1500 "
                 "queries against 1500 keys, non-causal, hd 64, bf16",
                 ATTN_ENCODER_UNIT),
                ("one pixtral-12b forward call: 40 launches, 2 x 512 causal "
                 "queries over their own 512 keys, hd 128, group 4, bf16",
                 ATTN_FWD_UNIT),
                ("the window bound streaming: 32 launches (mixtral's "
                 "layers), one slot, 64 queries at the end of 32768 keys, "
                 "window 4096, hd 128, group 4, bf16", ATTN_WINDOW_UNIT),
                ("one gemma-7b decode call: 28 launches, batch 4, 512-slot "
                 "cache, hd 256, group 1, bf16", ATTN_GEMMA_DECODE_UNIT)],
            "row_norm": [
                ("one long-context prefill-chunk call: 45 launches, 4096 "
                 "rows, d=2048, bf16", NORM_LONG_UNIT),
                ("mamba2's gated norms of one decode call (4 rows) and one "
                 "prefill call (256 rows): 48 launches each, d=4096, bf16",
                 NORM_SSM_UNIT)]}.get(name)
        if units:
            kernels[-1]["units"] = [
                {"work": w, **{k: v for k, v in times[u].items()
                               if k != "per_shape"}} for w, u in units]
    for name in BWD_KERNELS:
        t = bwd_times[name]
        src = "row_norm" if name.startswith("row_norm") else "row_attention"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": ("src/repro/models/layers.py:33" if src == "row_norm"
                         else "src/repro/models/attention.py:48"),
            "launches": train_launches[name],
            "max_abs_err": train_worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"],
            "work": t["work"] + " (the gradient XLA takes of the "
                    "reference's plain jnp; no TPU kernel)"})
    assert all(k["launches"] > 0 for k in kernels), \
        [(k["name"], k["launches"]) for k in kernels]
    assert len(WATERFALLS) == 10, sorted(WATERFALLS)
    log(f"[cost] the accounting and compression checks: "
        + ", ".join(f"{part} {secs:.2f} s" for part, secs in
                    COST_SECONDS.items())
        + f"; {sum(COST_SECONDS.values()):.2f} s in all; waterfalls of "
        f"{len(WATERFALLS)} archs; launches they add: phase 5b's "
        + ", ".join(f"{k} {n}" for k, n in comp_launches.items() if n))
    log(f"[smoke] all phases passed in {time.monotonic() - t_start:.1f} s "
        f"of wall time")
    print(_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
