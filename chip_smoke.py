"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives the port's paths at full width, with random weights from a seed:
the 1° GraphWeatherForecaster (64,800 grid points, 78 + 24 features, width
256, 9 processor blocks, the 5,882-cell hex mesh): serving, and training
(phases 32-35), and both in bf16 (phases 48-50); and the
GenCast denoiser (128 x 64 grid, splits-5 icosphere, 4 hops, hidden
(512, 512), 16 blocks, 4 heads, 89 -> 83 features, clustered attention):
serving, the 20-step sampler and AR rollout, and training; and WeatherMesh
at bench.py's full size (1 deg, 8 surface + 13 x 4 pressure channels, latent
128 on [14, 45, 90], conv blocks 2 x 2 of hidden 64, 2 + 4 + 2 neighborhood
attention layers, kernel (3, 5, 5), 4 heads): serving, the 8-step rollout
and training; and the same GenCast denoiser with banded attention
(attention_impl="banded_flash": lat-lon sorted k-hop graph, 21 receiver
blocks of 512 rows against windows of 2,560 keys): serving and training;
and the 768-d WeatherMesh (the same conv stack with the JAX package's
default attention: latent 768, 8 heads of 96, kernel (5, 7, 7), 3 + 10 + 3
layers), whose heads K5a cannot tile: served through K6, trained through K6
and its backward K6b; and both WeatherMesh models in bf16, as bench.py runs
them (phases 51-55); and FGN at bench.py's reference scale (128 x 64 grid,
89 -> 83 features, a noise vector of 32, 768-d, 24 blocks of 4 heads: c =
192, the last c = 768; splits-6 icosphere, 6 hops, clustered attention):
member requests, the 8-member ensemble, an ensemble rollout and remat
training, in f32 and bf16 (phases 56-61).
Phases, one line each, in order; any failure raises and ends the run with a
non-zero exit:

  1. card: nvidia-smi's name and power limit, torch and CUDA versions
  2. build: every CUDA kernel from csrc/, one nvcc each, all at once, timed
  3. the fused edge update in both modes of csrc/edge_mlp.cu, K1 (raw node
     rows) and K2 (per-node partial products), split-TF32 mma.sync, against
     their plain PyTorch versions at the three main-path shapes (g2m, latent,
     m2g), max abs error <= 1e-4, median CUDA-event times of both, per
     forward and bound; edge_mlp.cu's registers and spills (phase 2's line)
     and the count of TF32 tensor-core instructions in its SASS, which must
     not be 0
  4. serve: build the model on cuda, answer 3 requests (B=1), each with
     exactly 11 K2 launches and no K1 launch; NormalizedMSELoss; ms per
     request; a profile of one more (its kernel count, for phase 49)
  5. the same weights and one request on the CPU (plain versions):
     max abs difference from the card <= 1e-3
  6. a 4-step autoregressive rollout on the card: finite, 44 K2 launches,
     ms per step
  7. build: clustered_flash.cu's time, registers and spills, and the
     count of TF32 tensor-core instructions (HMMA ... TF32) in its SASS,
     which must not be 0 (cuobjdump)
  8. K3a (clustered flash attention, split-TF32 mma.sync) against its plain version on the real
     splits-5 layout at c = 128 and c = 512, B = 1: max abs error <= 1e-4,
     empty and padded rows exactly 0; CUDA-event medians of the kernel, the
     plain version and torch's scaled_dot_product_attention on the
     gathered unions (timed only, never used by the port)
  9. denoise: the full-width Denoiser on cuda answers 3 requests (B = 1,
     sigma = 1), each with exactly 16 K3a launches and one f32 S launch
     (the g2m aggregation in edge order); ms per request
 10. the same weights and one request on the CPU (plain versions): max abs
     difference from the card <= 1e-3
 11. sample: 2 samples of the 20-step sampler, 592 K3a launches each
 12. a 2-step AR sample rollout: finite, ms per AR step
 13. build: clustered_flash_bwd.cu's time, registers and spills, and its
     SASS's TF32 tensor-core instructions, as in phase 7
 14. K3c (symmetric) and K3b (general) backward on the real splits-5 layout
     at c = 128 and 512, B = 1: each against the plain backward and against
     each other, max abs error <= 1e-4; exact-zero gradients on empty and
     padded rows; CUDA-event medians of both, the plain version and SDPA's
     backward on the gathered unions (timed only); per train step: sums and
     the bound
 15. train: 3 steps of make_train_step (WeightedMSELoss, clip + AdamW at
     lr 1e-4, noise levels from sample_noise_level), each with exactly 16
     K3a, 16 K3c dq and 16 K3c dk/dv launches and no K3b launch; finite
     loss, parameters changed; ms per step, peak GiB; a profile of one more
     step; then two steps with remat=True (32 K3a launches each), peak GiB
 16. the same weights and one batch, forward and backward on the card
     twice, where the loss and gradients must repeat bit for bit (every
     graph sum runs in a fixed order: S in f32); then at 2 blocks
     (GENCAST_CHECK_BLOCKS: the trained first and last blocks) on the card
     and on the CPU (plain versions): loss within 1e-5 relative, every
     parameter's gradient within 1e-3 max|g| of that tensor (floored at
     1e-6 of the largest gradient)
 17. build: natten_flash.cu's registers and spills by instantiation
     (<CP, CL, NC, MINB>), and natten_flash_bwd.cu's
 18. K5a (3D neighborhood attention) against its plain version on the
     [1, 14, 45, 90] latent with rpb ~N(0, 0.5^2): (a) kernel (3, 5, 5),
     4 x 32; (b) the same with a circular W axis; (c) kernel (5, 7, 7),
     8 x 32; (d) kernel (3, 5, 5), 4 x 128, the widest head K5a takes. Max
     abs error <= 1e-4 on out and lse, and out and lse bit-equal over two
     launches; the plan (tile, lane group, chunk, slab strip, shared memory,
     CTAs an SM); CUDA-event medians of the kernel, with and without lse,
     the plain version and SDPA on the halo tiles of _pick_tile("fwd") with
     the window and rpb as an additive mask (timed only); per forward (8 x
     case a) and the bound
 19. wm_serve: the WeatherMesh answers 3 requests (B = 1), each with exactly
     8 K5a launches; ms per request, peak GiB, a profile of one more
 20. the same weights and the last request on the CPU: max abs difference
     <= 1e-3
 21. an 8-step rollout: finite, exactly 36 K5a launches, ms per step
 22. K5b against the plain backward in cases (a)-(c): dq, dk, dv within
     1e-4, drpb within 1e-4 of its max; medians of the whole backward and,
     apart, of its dq kernel (with the drpb partials), its dk/dv kernel,
     delta and the drpb sum, the plain backward and SDPA's backward; per
     train step and the bounds (both kernels, and each)
 23. wm_train: 3 steps of make_train_step (bench.py's objective: MSE on
     surface + MSE on pressure; clip + AdamW at lr 1e-4), each with exactly 8
     K5a, 8 dq and 8 dk/dv launches; finite loss, every parameter changed;
     ms per step, peak GiB, a profile of one more step
 24. the same weights and one batch at 3 deg (60 x 120), forward and
     backward on the card and on the CPU: loss within 1e-5 relative, every
     gradient within 1e-3 of its max|g| (the model's CPU convs run in
     PyTorch's own kernels, not oneDNN's, here and in phase 20); and once
     more on the card, where the loss and gradients must repeat bit for bit
     (the convs' backward on cuDNN's deterministic algorithms, the resize's
     a product)
 25. build: banded_flash.cu's and banded_flash_bwd.cu's registers and spills,
     and the count of TF32 tensor-core instructions in each library's SASS
     (K4a and K4b: split-TF32 mma.sync), which must not be 0
 26. K4a (banded flash attention) against its plain version on the real
     splits-5 band layout (nb 21, w 1024), B = 1, c = 128 and c = 512 x 4
     heads, with and without lse: max abs error <= 1e-4 on out and lse;
     padded rows exactly 0; CUDA-event medians of the kernel, the plain
     version and SDPA on the stacked windows with the band mask (timed
     only); per evaluation (15 x c = 128 + c = 512) and the bounds (FP32,
     and three TF32 products); the share of the band's pairs in 16 x 16
     tiles that hold an edge (those K4a and K4b compute), and in 16 x 8
 27. K4b against the plain backward in the same cases, its dk/dv kernel in
     the symmetric role (the k-hop graph is symmetric: band_symmetric) and
     in the general role: dq, dk, dv within 1e-4, exact zeros on padded
     rows; medians of both kernels in each role, the plain backward and
     SDPA's backward; per train step and the bounds (FP32, and three TF32
     products); then the general role on a directed band of the same size
     (10,242 nodes, w 1024), within 1e-4 with exact zeros
 28. band_serve: the banded_flash Denoiser with phase 9's weights answers
     phase 9's 3 requests, each with exactly 16 K4a launches and no K3a
     launch; ms per request, peak GiB, a profile of one more; max abs
     difference from phase 9's clustered output <= 1e-3; one request
     through attention_impl="banded" (plain PyTorch), timed only
 29. the same weights and the last request on the CPU (the twins): max abs
     difference <= 1e-3
 30. band_train: 3 steps of make_train_step as in phase 15, each with
     exactly 16 K4a, 16 dq and 16 dk/dv launches, the dk/dv kernel in its
     symmetric role, and no K3 launch; finite
     loss, every parameter changed; ms per step, peak GiB, a profile of one
     more step; then 2 steps with remat=True (32 K4a launches each), peak GiB
 31. the same weights and one batch at 2 blocks (GENCAST_CHECK_BLOCKS),
     forward and backward on the card and on the CPU: loss within 1e-5
     relative, every gradient within 1e-3 of its tensor's max|g|
 32. build: fused_mlp_bwd.cu's (K2b's) registers and spills, and the count
     of TF32 tensor-core instructions in its SASS (split-TF32 mma.sync),
     which must not be 0
 33. K2b (the fused edge update's backward) with the sums after it against
     the plain backward at the three main-path shapes, B = 1, broadcast e,
     m2g with dst_is_zero: every gradient within 1e-4 of its tensor's
     max|g|; CUDA-event medians of the kernel, the whole backward and the
     plain backward; per train step (g2m + 9 latent + m2g) and the bound
 34. fc_train: 3 steps of make_train_step on the 1° forecaster (bench.py's
     metric_train_step: NormalizedMSELoss(normalize=True), clip + AdamW at
     lr 1e-3), each with exactly 11 K2 and 11 K2b launches and no K1
     launch; finite loss, every parameter changed; ms per step, peak GiB, a
     profile of one more step; then 2 steps with use_checkpointing=True (20
     K2 launches each: 9 recomputed), peak GiB
 35. the same weights and one batch, forward and backward on the card twice,
     whose loss and gradients must repeat bit for bit (every sum on the
     forecaster's path runs in a fixed order), and on the CPU: loss within 1e-5 relative,
     every gradient within 1e-3 of its tensor's max|g|; then at the initial
     weights, with the CPU's float64 gradients beside: the loss within 1e-5,
     each gradient within 1e-3 of its tensor's max|g| or, where f32 rounding
     alone puts it outside, no further from float64 in norm than twice the
     CPU's float32 gradient (F32_NOISE_FACTOR)
 36. build: natten3d.cu's (K6's) registers and spills, and its SASS's TF32
     tensor-core instructions (0: K6 runs FP32 on the CUDA cores)
 37. K6 (the wide-head 3D neighborhood attention forward) against its
     plain version (neighborhood_attention_3d_reference) with rpb
     ~N(0, 0.5^2): (a) the wide layer, [1, 14, 45, 90] x 8 x 96 at
     (5, 7, 7); (b) (a) with a circular W axis; (c) phase 18's case a,
     4 x 32 at (3, 5, 5), through impl="pallas", also against K5a; (d) 2 x
     256 at (3, 5, 5); (e) 2 x 128 at (5, 7, 7); (f) 4 x 64 at (3, 5, 5):
     each of the kernel's instantiations. Max abs error <= 1e-4; CUDA-event medians of the
     kernel, the plain version and SDPA over each query's gathered window
     with rpb as an additive bias, in chunks of queries (timed only); per
     request (16 x case a) and the bound
 38. wm_wide_serve: the 768-d WeatherMesh answers 3 requests (B = 1), each
     with exactly 16 K6 and no K5a launches; ms per request, peak GiB, a
     profile of one more
 39. a 2-step rollout: finite, exactly 26 K6 launches, ms per step
 40. the same weights and one request at 28 x 60 (latent [14, 7, 15]) and
     2 processor layers (WM_WIDE_CHECK_LAYERS) on the card (8 K6 launches)
     and on the CPU: max abs difference <= 1e-3; the CPU forward timed
 41. K6 with lse, and K6b (its backward: the dq kernel, which writes each
     pair's p and ds to a slot table, and the dk/dv kernel, which reads
     them) against the plain backward (natten_flash_backward_reference) on
     K6's out and lse, in phase 37's cases a, b, d, e and f and (g) case a
     without rpb: out and lse within 1e-4 of the plain version's, each of
     dq, dk, dv and drpb within 1e-4 of its tensor's max|g|, out, lse and
     the gradients bit-equal over two launches; the plans and the table's
     bytes; CUDA-event medians of K6 with and without lse, of each K6b
     kernel (the dq kernel forms delta = rowsum(dO * out) itself), of the
     whole backward (with the table's allocation and the drpb sum), of the
     plain backward and of SDPA's backward over
     each query's gathered window with rpb as an additive bias, in chunks
     of 2 GiB (the last two timed only, SDPA_BWD_RUNS runs); per train step
     (16 x case a) and the bounds
 42. wm_wide_train: 3 steps of make_train_step on the 768-d WeatherMesh
     (phase 23's objective and optimiser, phase 38's weights), each with
     exactly 16 K6 (with lse), 16 K6b dq and 16 K6b dk/dv launches and no
     K5a or K5b launch; finite loss, every parameter changed; ms per step,
     peak GiB, a profile of one more step
 43. the same weights and one batch at 28 x 60 (latent [14, 7, 15]; at 3
     deg the CPU would take ~4 min), forward and backward on the card
     twice, where the loss and gradients must repeat bit for bit; then at
     2 processor layers (WM_WIDE_CHECK_LAYERS) on the card and on the CPU:
     loss within 1e-5 relative, every gradient within 1e-3 of its tensor's
     max|g|
 44. GenCast's bf16 policy: the bf16 instantiations of clustered_flash.cu
     and clustered_flash_bwd.cu (phase 2's build; their bf16 tensor-core
     instructions in SASS, which must not be 0), then K3a in bf16 (with and
     without lse), K3c and K3b in bf16 against their plain versions on bf16
     inputs on the real splits-5 layout at c = 128 and 512: out, dq, dk, dv
     within 2^-6 of their max (two bf16 ulps), lse within 1e-4, exact zeros
     on empty rows; CUDA-event medians (batches of 5) of each, of the f32
     kernel on the same values, of the plain version and of SDPA in bf16 on
     the gathered unions (timed only); CTAs an SM of each kernel in f32 and
     bf16; per evaluation and the bounds (989 TFLOP/s dense BF16)
 45. serve_bf16: phase 9's weights and requests through
     forward_fn(compute_dtype=torch.bfloat16), each with exactly 16 bf16
     K3a launches and no f32 K3 launch, f32 out; ms per request, then one
     request at B = 4 (bench.py's denoiser_batch4), ms per sample; a profile
     of one more; the last request on the CPU in bf16: RMSE(card bf16 - CPU
     bf16) <= 0.75 RMSE(card bf16 - card f32 of phase 9) (BF16_CARD_RULE;
     the CPU against itself with 1 in 2,000 inputs one ulp off, printed);
     the request times beside the earlier bf16 ones (GENCAST_BF16_EARLIER_MS,
     before its bf16 segment sums ran through S)
 46. a bf16 20-step sample (592 bf16 K3a launches) and a 2-step AR rollout,
     timed, finite, f32; the sample time beside the earlier one
 47. train_bf16: 3 steps of bench.py's gencast_train objective (mean squared
     error, noise level 1, clip + AdamW at lr 1e-4) through the bf16
     forward_fn, each with exactly 16 bf16 K3a, 16 K3c dq and 16 K3c dk/dv
     launches and no K3b or f32 K3 launch; the parameters stay f32 and all
     change; ms per step, peak GiB, a profile of one more step; then the
     bf16 gradients of phase 16's objective at phase 16's weights and batch,
     on the card and on the CPU: global norm of card - CPU <= 0.9 global
     norm of card bf16 - card f32 (phase 16's gradients; BF16_CARD_GRAD_RULE),
     with the CPU's own reading (its gradients with 1 in 2,000 inputs one
     ulp off) taken and printed beside a miss (it read 0.668 against the
     card's 0.665-0.672 in PRs 16-18); the step time beside the earlier one
 48. the forecaster's bf16 kernels (phase 2's build): the count of bf16
     tensor-core instructions (HMMA ... BF16) in edge_mlp.cu's and
     fused_mlp_bwd.cu's SASS, which must not be 0, and S's registers; K2 in
     bf16 and K2b in bf16 (with the sums after it) against their plain
     versions on bf16 operands at the g2m, latent and m2g shapes, within
     2^-6 of the plain output's (each gradient's) max; S against its plain
     version, bit-equal, on each graph's receivers and senders; CUDA-event
     medians (batches of 5) of each kernel, of the f32 kernel on the same
     values, of the plain version and, for S, of index_add_ in bf16 (timed
     only); per forward (K2) or train step (K2b, S's 22 sums) and the
     bounds (bytes over 3.35 TB/s, operations over 989 TFLOP/s)
 49. fc_serve_bf16: phase 4's weights and requests through
     forward_fn(compute_dtype=torch.bfloat16), each with exactly 11 bf16 K2
     launches, one S launch (the g2m aggregation) and no f32 K2 or K1
     launch, f32 out; ms per request beside phase 4's; the kernels of a
     profiled request, at most 1.5 x phase 4's f32 count; a 4-step bf16
     rollout, finite, ms per step; the last request on the CPU in bf16 at
     1°: RMSE(card bf16 - CPU bf16) <= the larger of 0.5 (FC_BF16_RULE) and
     the CPU's own reading (one_ulp_off) x RMSE(card bf16 - card f32)
 50. fc_train_bf16: 3 steps of bench.py's bf16 train_step objective
     (phase 34's: NormalizedMSELoss(normalize=True), clip 1 + AdamW at lr
     1e-3, phase 34's batch) through the bf16 forward_fn, each with exactly
     11 bf16 K2, 11 bf16 K2b and 22 S launches and no f32 K2, K2b or K1
     launch; the parameters and the optimizer's moments stay f32, every
     parameter changes; ms per step beside phase 34's, peak GiB, the
     kernels of a profiled step; then at those weights the bf16 loss and
     gradients on the card twice, bit for bit the same, and on the CPU at
     1°: global norm of card bf16 - CPU bf16 within phase 49's rule of the
     global norm of card bf16 - card f32 (the CPU's own reading, a second
     CPU run, taken only where the card misses 0.5, as phases 53 and 55)
 51. WeatherMesh's bf16 kernels (phase 2's build; their registers and
     spills): K5a and K5b in bf16 at phase 18's case a, K6 and K6b in bf16 at
     phase 37's cases a and b, each against its plain version in bf16 (the
     TPU kernels' roundings; the slot scan's as XLA computes it): out and
     every gradient within 2^-6 of its max (BF16_TOL), lse (and K6's out32,
     its f32 result before the rounding) within 1e-4, all bit-equal over
     two launches; CUDA-event medians of each bf16 kernel (K5b's two and
     K6b's four apart), of the f32 kernel on the same values, of the plain
     version and of SDPA in bf16 on the same windows (timed only); per
     request or train step and the bounds (2 bytes an element, 989 TFLOP/s)
 52. wm_serve_bf16: phase 19's weights and requests through
     apply(compute_dtype=torch.bfloat16), each with exactly 8 bf16 K5a
     launches and no other attention launch, bf16 out; ms per request beside
     phase 19's, peak GiB, the kernels of a profiled request; a 4-step
     rollout, finite
 53. wm_train_bf16: 3 steps of phase 23's objective and optimiser through
     forward_fn(compute_dtype=torch.bfloat16), each with exactly 8 bf16 K5a
     (with lse), 8 bf16 K5b dq and 8 dk/dv launches and no other attention
     launch; f32 parameters and moments, every parameter changed; ms per
     step beside phase 23's, peak GiB, a profile; then at those weights the
     bf16 gradients on the card (twice: whether they repeat, printed) and on
     the CPU at 3° (WM_CHECK_GRID): global norm of card bf16 - CPU bf16
     within the larger of 0.5 (BF16_WM_RULE) and the CPU's own one-ulp
     reading of the global norm of card bf16 - card f32 (a second CPU run,
     taken only where the card misses 0.5)
 54. wm_wide_serve_bf16: phase 52 for the 768-d model (phase 38's weights and
     requests, 16 bf16 K6 launches a request)
 55. wm_wide_train_bf16: phase 53 for the 768-d model, each step with exactly
     16 bf16 K6 (with lse and out32), 16 bf16 K6b dq, 16 dk/dv and 16 of each
     drpb kernel; the CPU check at 28 x 60 (WM_WIDE_GRAD_GRID) and 2
     processor layers (WM_WIDE_CHECK_LAYERS), the repeat at full depth
 56. FGN's build: registers and spills of K3a's and K3c's c = 768
     instantiations (W768: one row group of 8 warps of 96 channels; one copy
     stage in f32, two in bf16), and the tensor-core instructions in each
     one's SASS (TF32 in f32, BF16 in bf16: neither total may be 0)
 57. FGN's graphs (splits 6, 6 hops: 40,962 mesh nodes, 5,156,760 k-hop
     edges, 161 blocks of 256 rows, U_pad 1,024) and each graph's sum route;
     K3a (with and without lse) and K3c at c = 192 and
     768, f32 and bf16, on that layout at B = 1: against the plain versions
     (f32 1e-4; bf16 2^-6 of the max, lse 1e-4), exact zeros on empty rows,
     a bit-equal repeat; CUDA-event medians of each, of the plain versions
     and of SDPA and its backward on the gathered unions (timed only, with
     the backend SDPA took); the bounds; CTAs an SM; S in f32 against its
     plain version, bit for bit, on the g2m receivers and m2g senders at 768
     columns, timed beside index_add_
 58. fgn_serve (f32): 3 member requests at B = 1 after a warm-up, each with
     exactly 24 K3a launches (23 at c = 192, one at 768: the W768 tile's
     own counter) and one f32 S (the g2m aggregation); ms, peak GiB, a
     profile of one more (K3a's device ms, all and at c = 768); the
     8-member ensemble with member_chunk=1 (192 K3a, 8 at c = 768), ms per
     member; a 2-member 2-step ensemble rollout (a handle with 89 outputs,
     the same graphs), ms per step
 59. fgn_serve_bf16: phase 58 through member_fn(compute_dtype=bfloat16), the
     bf16 counts
 60. fgn_train: 3 steps of bench.py's fgn_member_train_ms (MSE through the
     member, clip + AdamW at lr 1e-4) with remat=True, in bf16 then f32,
     each with exactly 48 K3a (with lse: remat recomputes each block), 24
     K3c dq, 24 K3c dk/dv (of which 2, 1 and 1 at c = 768) and 5 S launches
     of its dtype and no K3b launch; every parameter changes; ms per step
     (median of steps 2-3), peak GiB, a profile of one more step (K3c's
     device ms); then the loss and gradients twice at those weights:
     bit-equal
 61. the card against the CPU at full width and 2 blocks (one at c = 192,
     the last at 768): f32 output within 1e-3, loss within 1e-5 relative,
     each gradient within 1e-3 of its max|g|; bf16: RMSE(card bf16 - CPU
     bf16) within 0.75 (output) and 0.9 (gradients, global norm) of the
     card's bf16-to-f32 distance, GenCast's rule (phases 45, 47), the
     card's own one-ulp reading printed beside it; beside a miss the CPU's
     own reading, and the limit the larger of that, 0.5 and GenCast's

then one JSON line on the kernels, the card's name and power limit, and
last {"ok": true, "device": ...}.
Exits non-zero without a CUDA device, or when the port's package is not
beside this file. f32 but for phases 44-55 and FGN's bf16 (bf16); TF32 is
off, but for the bf16 WeatherMesh's convolutions of bf16 values (exact in
TF32).
"""

from __future__ import annotations

import dataclasses
import faulthandler
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FEATURE_DIM, AUX_DIM = 78, 24
K1_TOL = 1e-4  # LayerNorm'd O(1) outputs; only the summation order differs (K1 and K2)
K2B_TOL = 1e-4  # each gradient, of its tensor's max|g|: sums over <= 64,800 rows in another order
EDGE_UPDATES = {"g2m": 1, "latent": 9, "m2g": 1}  # launches per forecaster forward
K3A_TOL = 1e-4  # softmax-weighted sums over <= 768 keys in another order
K3_BWD_TOL = 1e-4  # gradient sums over <= 768 keys or 256 receivers in another order
LOSS_RTOL = 1e-5  # the training loss, card against CPU
GRAD_RTOL = 1e-3  # each parameter's gradient, card against CPU, of that tensor's max|g|
# Phase 35 at the forecaster's initial weights: a gradient outside GRAD_RTOL
# of the CPU's passes if the card's is no further from the CPU's float64
# gradient (norm of the difference) than this many times the CPU's own float32
# gradient is. There f32 rounding alone puts some of the encoder's gradients
# outside GRAD_RTOL (the mesh seeds' gradient is orders of magnitude below
# the largest), and the phase prints each such tensor's two readings.
F32_NOISE_FACTOR = 2.0
CPU_TOL = 1e-3  # 11 message-passing rounds, or 16 attention blocks, of f32 in another order
TIMING_RUNS = 10
# NVIDIA's H100 SXM data sheet (dense, at the 700 W limit): FP32 on the CUDA
# cores, and HBM3. A kernel's bound is the larger of flops / FP32_PEAK and
# bytes / HBM_RATE, for the work these inputs need.
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# The same sheet's dense TF32 tensor-core rate: a kernel that splits each f32
# product into three TF32 products (K1, K2, K2b, K3a-c, K4a, K4b) has, beside
# its FP32 bound, the bound of 3 x its operations at this rate.
TF32_PEAK = 495e12
# And its dense BF16 tensor-core rate: the bound of the bf16 kernels (K3a-c
# in bf16), with HBM_RATE.
BF16_PEAK = 989e12
# Two bf16 ulps (8 significant bits) of a tensor's largest value: a bf16
# kernel and its plain version round p, ds and the outputs to bf16 at the
# same points but sum in f32 in another order (phase 44).
BF16_TOL = 2.0**-6
# Phases 45 and 47: RMSE(card bf16 - CPU bf16) within a share of RMSE(card
# bf16 - card f32): 0.75 on the output, 0.9 in the global norm of the
# gradients. Not the CPU tests' 0.5: at this width the bf16 denoiser's output
# moves 0.58 of its bf16-to-f32 distance, and its gradients 0.75, when one in
# 2,000 of its input elements changes by one bf16 ulp, on the CPU and on the
# card alike, at 2 to 16 blocks (an H100 80GB HBM3 at 700 W): a change
# smaller than an ulp flips a share of each later rounding. cuBLAS's and
# oneDNN's bf16 GEMMs differ in one output rounding in ~3,400 (f32 sums in
# another order), so the card sits at those readings against the CPU (0.58;
# 0.66-0.75); a port rounding SiLU once, as F.silu does, where the policy
# rounds each step, reads 1.09 and 1.12 (PERF.md §6). Phase 45 prints the
# CPU's own reading of the output.
BF16_CARD_RULE = 0.75
BF16_CARD_GRAD_RULE = 0.9
BF16_FLIP_SHARE = 5e-4  # one-ulp input changes, for the CPU's own reading (phases 45, 47, 49, 50)
# GenCast's bf16 times while its bf16 segment sums ran as a loop of
# index_add_ with host syncs (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W),
# printed beside phases 45-47's: ms per request at B = 1, per 20-step
# sample, per train step (median of steps 2-3).
GENCAST_BF16_EARLIER_MS = {"request": (32.0, 57.0), "sample": (1491.0, 1701.0), "step": (134.6, 173.4)}
# Phases 49 and 50: RMSE(card bf16 - CPU bf16) within the larger of this
# share of RMSE(card bf16 - card f32) (the global norm of the gradients)
# and the CPU's own reading (one_ulp_off).
FC_BF16_RULE = 0.5
# GenCast: bench.py's _make_denoiser at full size.
GENCAST = dict(
    grid_lon=np.arange(0.0, 360.0, 360.0 / 128), grid_lat=np.linspace(-90.0, 90.0, 64),
    input_features_dim=89, output_features_dim=83, hidden_dims=(512, 512),
    num_blocks=16, num_heads=4, splits=5, num_hops=4, use_edges_features=False,
    attention_impl="clustered_flash",
)
EVALS_PER_SAMPLE = 2 * (20 - 2) + 1
# WeatherMesh: bench.py's _make_weathermesh(quick=False), 1 deg, 13 levels.
WEATHERMESH = dict(
    timesteps=[6], surface_channels=8, pressure_channels=4, pressure_levels=13,
    latent_dim=128, encoder_num_conv_blocks=2, encoder_num_transformer_layers=2,
    encoder_hidden_dim=64, decoder_num_conv_blocks=2, decoder_num_transformer_layers=2,
    decoder_hidden_dim=64, processor_num_layers=4, kernel=(3, 5, 5), num_heads=4,
)
WM_GRID = (180, 360)
WM_CHECK_GRID = (60, 120)  # phases 24 and 53's card-against-CPU checks, at 3 deg
WM_LATENT = (14, 45, 90)  # 13 levels + the surface slice, on 180/4 x 360/4
K5_PER_FORWARD = 8  # 2 encoder + 4 processor + 2 decoder attention layers
K5_TOL = 1e-4  # softmax-weighted sums over <= 245 keys in another order
K4_TOL = 1e-4  # softmax-weighted sums over <= 2,560 window slots in another order
# The 768-d WeatherMesh: WEATHERMESH's conv stack with the JAX package's
# default attention (models/weathermesh/model.py): 8 heads of 96 at kernel
# (5, 7, 7), 3 + 10 + 3 layers. K5a cannot tile these heads; K6 takes them.
WM_WIDE = {
    **WEATHERMESH, "latent_dim": 768, "num_heads": 8, "kernel": (5, 7, 7),
    "encoder_num_transformer_layers": 3, "processor_num_layers": 10,
    "decoder_num_transformer_layers": 3,
}
WM_WIDE_CHECK_GRID = (28, 60)  # phase 40's card-against-CPU forward
WM_WIDE_GRAD_GRID = (28, 60)  # phase 43's card-against-CPU gradients: latent [14, 7, 15]
# Phases 40, 43 and 55 hold the 768-d model against the CPU at this processor
# depth (3 + 2 + 3 attention layers, the trained model's first two processor
# layers), and phases 16 and 31 GenCast's gradients at GENCAST_CHECK_BLOCKS
# blocks (its first and its last, heads-averaged, one): at full depth, with
# FGN's phases, the script took 1,296 s of its 1,200 on an H100 whose host
# ran the CPU checks ~1.5x slower than others (phase 43 97 s, 40 48 s, 31
# 44 s, 16 41 s, 55 86 s at full depth there or before; PERF.md §6, PR 18).
WM_WIDE_CHECK_LAYERS = 2
GENCAST_CHECK_BLOCKS = 2
K6_PER_FORWARD = 16  # 3 encoder + 10 processor + 3 decoder attention layers
# Phases 53 and 55: the bf16 gradients card against CPU, RMSE(card bf16 - CPU
# bf16) in global norm within the larger of this share of RMSE(card bf16 -
# card f32) and the CPU's own reading (one_ulp_off), at WM_CHECK_GRID and
# WM_WIDE_GRAD_GRID.
BF16_WM_RULE = 0.5
GENCAST_BANDED = {**GENCAST, "attention_impl": "banded_flash"}


def grid(spacing: float) -> list[tuple[float, float]]:
    """bench.py's grid: lat -90..90-spacing, lon 0..360-spacing, row-major."""
    lats = np.arange(-90.0, 90.0, spacing)
    lons = np.arange(0.0, 360.0, spacing)
    return [(float(a), float(b)) for a in lats for b in lons]


def cuda_ms(fn, runs: int = TIMING_RUNS, batch: int = 5) -> float:
    """Median time of one fn() on the card: CUDA events around `batch`
    launches in a row (so the host's launch overhead overlaps the device's
    work), `runs` times, after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for `flops` FP32 operations
    that must move `nbytes` bytes."""
    by_ops, by_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def tf32x3_ms(flops: float) -> float:
    """Least ms for `flops` f32-equivalent operations done as three TF32
    tensor-core products each."""
    return 3 * flops / TF32_PEAK * 1e3


def k1_case(edge_mlp, name, bundle, with_dst, gen, width=256):
    """K1 (raw mode) against its plain version on the graph `bundle` at full
    width. Returns (max abs error, kernel ms, plain ms, flops, bytes)."""
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    k0 = 3 * width
    args = (
        torch.as_tensor(bundle.senders, device=dev),
        torch.as_tensor(bundle.receivers, device=dev),
        rnd(1, bundle.n_senders, width),
        rnd(1, bundle.n_receivers, width) if with_dst else None,
        rnd(bundle.n_edges, width),  # batch-broadcast, as the first round sees it
        rnd(k0, width, scale=k0**-0.5), rnd(width, scale=0.1),
        rnd(width, width, scale=width**-0.5), rnd(width, scale=0.1),
        rnd(width, width, scale=width**-0.5), rnd(width, scale=0.1),
        1.0 + rnd(width, scale=0.1), rnd(width, scale=0.1),
    )
    out = edge_mlp.fused_edge_mlp(*args)
    torch.cuda.synchronize()
    ref = edge_mlp.fused_edge_mlp_reference(*args)
    err = (out - ref).abs().max().item()
    ms = cuda_ms(lambda: edge_mlp.fused_edge_mlp(*args))
    plain_ms = cuda_ms(lambda: edge_mlp.fused_edge_mlp_reference(*args))
    print(
        f"[k1] {name}: E={bundle.n_edges} N_src={bundle.n_senders} "
        f"N_dst={bundle.n_receivers} x_dst={'yes' if with_dst else 'None'} "
        f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
        flush=True,
    )
    if not (err <= K1_TOL):
        raise AssertionError(f"K1 {name}: max abs error {err} > {K1_TOL}")
    # Per edge: the x_src, x_dst and e rows of layer 1, then two H x H-wide layers.
    in_rows = 3 if with_dst else 2
    flops = 2 * bundle.n_edges * width * (in_rows * width + 2 * width)
    # Bytes: the rows each edge gathers (x_src, x_dst) and its e and e' rows,
    # as the Pallas kernels count them (ops/pallas/fused_mlp.py:102).
    nbytes = 4 * bundle.n_edges * ((in_rows - 1) * width + 2 * width)
    return err, ms, plain_ms, flops, nbytes


def k2_inputs(graph, with_dst, gen, width=256):
    """K2's operands on `graph` (a DeviceGraph on the card) at full width, as
    the model gives them: partials [1, N, H], batch-broadcast e [E, Fe]."""
    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    return (
        graph.senders, graph.receivers,
        rnd(1, graph.n_senders, width), rnd(1, graph.n_receivers, width) if with_dst else None,
        rnd(graph.senders.shape[0], width),
        rnd(width, width, scale=width**-0.5), rnd(width, scale=0.1),
        rnd(width, width, scale=width**-0.5), rnd(width, scale=0.1),
        rnd(width, width, scale=width**-0.5), rnd(width, scale=0.1),
        1.0 + rnd(width, scale=0.1), rnd(width, scale=0.1),
    )


def k2_case(fused_mlp, name, graph, with_dst, gen, width=256):
    """K2 (partial-product mode) against its plain version. Returns (max abs
    error, kernel ms, plain ms, flops, bytes)."""
    args = k2_inputs(graph, with_dst, gen, width)
    tables = dict(sender_sum=graph.sender_sum, receiver_sum=graph.receiver_sum)
    out = fused_mlp.fused_edge_update(*args, **tables)
    torch.cuda.synchronize()
    err = (out - fused_mlp.fused_edge_update_reference(*args)).abs().max().item()
    ms = cuda_ms(lambda: fused_mlp.fused_edge_update(*args, **tables))
    plain_ms = cuda_ms(lambda: fused_mlp.fused_edge_update_reference(*args))
    print(f"[k2] {name}: E={graph.senders.shape[0]} p_dst={'yes' if with_dst else 'None'} "
          f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}", flush=True)
    if not (err <= K1_TOL):
        raise AssertionError(f"K2 {name}: max abs error {err} > {K1_TOL}")
    # Per edge: e We, then two H x H-wide layers. Bytes: the partial rows each
    # edge gathers (p_src, p_dst) and its e and e' rows, the Pallas kernel's
    # own count (bytes_accessed, graph_weather_tpu/ops/pallas/fused_mlp.py:102).
    n_edges = graph.senders.shape[0]
    flops = 2 * n_edges * width * 3 * width
    nbytes = 4 * n_edges * ((2 if with_dst else 1) * width + 2 * width)
    return err, ms, plain_ms, flops, nbytes


def k2b_case(fused_mlp, name, graph, with_dst, gen, width=256):
    """K2b and the sums after it against the plain backward, B = 1, on the
    graph's own CSR tables, at the kernel's ReLU masks: a pre-activation
    within rounding of 0 may fall on either side in two f32 computations, and
    the gradient jumps there, so the plain backward takes the kernel's h0 and
    h1 (themselves held within 1e-4 of the plain forward's; the ties are
    counted). Returns a dict of the worst error over max|g|, times (ms: the
    kernel alone, the whole backward, the plain backward), flops and bytes
    of the kernel."""
    args = k2_inputs(graph, with_dst, gen, width)
    dout = torch.randn(1, graph.senders.shape[0], width, generator=gen, device="cuda")
    tables = (graph.sender_sum, graph.receiver_sum)

    def kernel():
        return fused_mlp.launch_backward(*args[:12], dout)

    outs, sums = kernel()
    # Per edge: the partial rows it gathers, its e and dout rows, and the six
    # rows written (h0, h1, dh1, dh0, dh2, de), as K2's bytes are counted.
    kernel_bytes = 4 * dout.shape[1] * (((2 if with_dst else 1) + 4) * width + 4 * width)
    activations = outs[:2]
    plain = fused_mlp.fused_edge_update_activations(*args[:9])
    act_err = max((a - p).abs().max().item() for a, p in zip(activations, plain))
    ties = sum(int(((a > 0) != (p > 0)).sum()) for a, p in zip(activations, plain))
    del outs, sums, plain
    if not (act_err <= K1_TOL):
        raise AssertionError(f"K2b {name}: recomputed h0/h1 max abs error {act_err} > {K1_TOL}")
    got = fused_mlp._backward_cuda(*args, dout, *tables)
    torch.cuda.synchronize()
    want = fused_mlp.fused_edge_update_backward_reference(*args, dout, *tables, activations=activations)
    names = ("p_src", "p_dst", "e", "we", "b0", "w1", "b1", "w2", "b2", "gamma", "beta")
    errs = {n: (g - w).abs().max().item() / w.abs().max().item()
            for n, g, w in zip(names, got, want) if w is not None}
    worst = max(errs, key=errs.get)
    del got, want, activations
    ms = {
        "kernel": cuda_ms(kernel),
        "backward": cuda_ms(lambda: fused_mlp._backward_cuda(*args, dout, *tables)),
        "plain": cuda_ms(lambda: fused_mlp.fused_edge_update_backward_reference(*args, dout, *tables)),
    }
    print(f"[k2b] {name}: E={graph.senders.shape[0]} p_dst={'yes' if with_dst else 'None'} sums to "
          f"senders and receivers through {len(tables[0])} and {len(tables[1])} padded CSR "
          f"levels | h0/h1 max_abs_err "
          f"{act_err:.3e}, ReLU ties {ties} of {2 * dout.numel()} | worst error / max|g| "
          f"{errs[worst]:.3e} ({worst}) | kernel_ms={ms['kernel']:.4f} backward_ms="
          f"{ms['backward']:.4f} plain_ms={ms['plain']:.4f}", flush=True)
    if not (errs[worst] <= K2B_TOL):
        raise AssertionError(f"K2b {name}: {worst} error {errs[worst]} of its max|g| > {K2B_TOL}")
    # Per edge: the three forward products again, then dh1, dh0 and de.
    flops = 2 * graph.senders.shape[0] * width * 6 * width
    return dict(err=errs[worst], ms=ms, flops=flops, nbytes=kernel_bytes)


def k3a_case(clustered_flash, khop, gen, c, heads=4):
    """K3a against its plain version at the processor's shapes: q/k/v
    [1, nb * block, heads, c] (rows padded once by the processor), on the
    real cluster layout. Returns (max abs error, kernel ms, plain ms, SDPA
    ms, flops, bytes)."""
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    n_pad = ids.shape[0] * block
    q, k, v = (torch.randn(1, n_pad, heads, c, generator=gen, device="cuda") for _ in range(3))
    args = (q, k, v, ids, masks, block)
    out = clustered_flash.clustered_flash_attention(*args)
    torch.cuda.synchronize()
    ref = clustered_flash.clustered_flash_forward_reference(*args)
    err = (out - ref).abs().max().item()
    empty = ~masks.reshape(n_pad, -1).bool().any(-1)  # no neighbour, or padding
    zeros = bool((out[:, empty] == 0).all())
    ms = cuda_ms(lambda: clustered_flash.clustered_flash_attention(*args))
    plain_ms = cuda_ms(lambda: clustered_flash.clustered_flash_forward_reference(*args))
    # The library yardstick: one SDPA call on the gathered unions, with the
    # adjacency as a boolean mask (gathers outside the timing). Rows without
    # a neighbour give NaN there, so it is timed, never compared.
    nb, u_pad = ids.shape
    q_b = q.reshape(nb, block, heads, c).transpose(1, 2)
    k_b, v_b = (t[0, ids.long()].transpose(1, 2) for t in (k, v))  # [nb, h, U, c]
    attend = masks.bool()[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = cuda_ms(lambda: sdpa(q_b, k_b, v_b, attn_mask=attend))
    print(
        f"[k3a] c={c}: nb={nb} block={block} U_pad={u_pad} heads={heads} "
        f"empty_rows={int(empty.sum())} max_abs_err={err:.3e} empty_rows_zero={zeros} "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={sdpa_ms:.4f}",
        flush=True,
    )
    if not (err <= K3A_TOL):
        raise AssertionError(f"K3a c={c}: max abs error {err} > {K3A_TOL}")
    if not zeros:
        raise AssertionError(f"K3a c={c}: rows without a neighbour are not exactly 0")
    # The work these inputs need: q.k and p.v over the real edges.
    n_edges = khop.senders.shape[0]
    flops = 4 * n_edges * heads * c
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, ids, masks, out))
    return err, ms, plain_ms, sdpa_ms, flops, nbytes


def k3_bwd_case(clustered_flash, khop, scatter, gen, c, heads=4):
    """K3c and K3b against the plain backward at the processor's shapes on
    the real cluster layout, after K3a with lse; `scatter` is K3b's inverse
    index of the layout. Returns a dict of errors, times (ms), flops, bytes
    and K3b's launches in the checked call (before the timings)."""
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    nb, u_pad = ids.shape
    n_pad = nb * block
    q, k, v, dout = (torch.randn(1, n_pad, heads, c, generator=gen, device="cuda") for _ in range(4))
    out, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    args = (q, k, v, ids, masks, out, lse, dout, block)

    def k3c():
        return clustered_flash._backward_cuda(*args, True, None)

    def k3b():
        return clustered_flash._backward_cuda(*args, False, scatter)

    before = clustered_flash.GENERAL_BWD_LAUNCHES
    sym, general = k3c(), k3b()
    k3b_launches = clustered_flash.GENERAL_BWD_LAUNCHES - before
    if k3b_launches != 1:
        raise AssertionError(f"the general backward made {k3b_launches} K3b launches, expected 1")
    torch.cuda.synchronize()
    want = clustered_flash.clustered_flash_backward_reference(*args, symmetric=False)

    def err(a, b):
        return max((x - y).abs().max().item() for x, y in zip(a, b))

    errs = {"k3c": err(sym, want), "k3b": err(general, want), "k3b_vs_k3c": err(general, sym)}
    empty = ~masks.reshape(n_pad, -1).bool().any(-1)  # no neighbour, or padding
    zeros = all(bool((t[:, empty] == 0).all()) for t in (*sym, *general))
    with_lse_ms = cuda_ms(lambda: clustered_flash._forward_cuda(q, k, v, ids, masks, block, True))
    ms = {"k3c": cuda_ms(k3c), "k3b": cuda_ms(k3b)}
    plain = {
        "k3c": cuda_ms(lambda: clustered_flash.clustered_flash_backward_reference(*args, symmetric=True)),
        "k3b": cuda_ms(lambda: clustered_flash.clustered_flash_backward_reference(*args, symmetric=False)),
    }
    # The library yardstick: SDPA's backward on the gathered unions with the
    # adjacency as a boolean mask (gathers and forward outside the timing);
    # rows without a neighbour give NaN there, so it is timed, never compared.
    q_b = q.reshape(nb, block, heads, c).transpose(1, 2).detach().requires_grad_(True)
    k_b, v_b = (t[0, ids.long()].transpose(1, 2).detach().requires_grad_(True) for t in (k, v))
    do_b = dout.reshape(nb, block, heads, c).transpose(1, 2)
    o_b = torch.nn.functional.scaled_dot_product_attention(q_b, k_b, v_b, attn_mask=masks.bool()[:, None])
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(o_b, (q_b, k_b, v_b), do_b, retain_graph=True))
    print(
        f"[k3_bwd] c={c}: max_abs_err K3c {errs['k3c']:.3e} K3b {errs['k3b']:.3e} "
        f"K3b-K3c {errs['k3b_vs_k3c']:.3e} | empty_rows {int(empty.sum())} zero_grads={zeros} "
        f"| K3c_ms={ms['k3c']:.4f} K3b_ms={ms['k3b']:.4f} plain_ms K3c {plain['k3c']:.4f} "
        f"K3b {plain['k3b']:.4f} sdpa_bwd_ms={sdpa_ms:.4f} | K3a with lse ms={with_lse_ms:.4f}",
        flush=True,
    )
    for name, e in errs.items():
        if not (e <= K3_BWD_TOL):
            raise AssertionError(f"{name} c={c}: max abs error {e} > {K3_BWD_TOL}")
    if not zeros:
        raise AssertionError(f"K3b/K3c c={c}: rows without a neighbour have non-zero gradients")
    # The work these inputs need: s, dp, dq, dk and dv over the real edges.
    flops = 10 * khop.senders.shape[0] * heads * c
    nbytes = sum(t.numel() * t.element_size() for t in (*args[:-1], *sym))
    return dict(errs=errs, ms=ms, plain=plain, sdpa_ms=sdpa_ms, flops=flops, nbytes=nbytes,
                k3b_launches=k3b_launches)


def bf16_bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for `flops` operations on the
    tensor cores' dense BF16 rate that must move `nbytes` bytes."""
    by_ops, by_bytes = flops / BF16_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def bf16_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over BF16_TOL max |want|: within the rule at <= 1)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / (BF16_TOL * want.float().abs().max().item())


def one_ulp_off(t: torch.Tensor, seed: int) -> tuple[torch.Tensor, int]:
    """t on the host, rounded to bf16, with one bf16 ulp added to a random
    BF16_FLIP_SHARE of its elements, as f32; and how many moved. The CPU's
    own reading of a bf16 path (phases 45, 47, 49, 50) is how far its
    output or gradients move for this input."""
    t16 = t.cpu().bfloat16()
    flips = torch.rand(t16.shape, generator=torch.Generator().manual_seed(seed)) < BF16_FLIP_SHARE
    return torch.where(flips, torch.nextafter(t16, torch.full_like(t16, 1e9)), t16).float(), int(flips.sum())


def rmse(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def global_norm(grads: dict) -> float:
    return math.sqrt(sum(g.double().pow(2).sum().item() for g in grads.values()))


def k3_bf16_case(clustered_flash, khop, scatter, gen, c, heads=4):
    """K3a (with and without lse), K3c and K3b in bf16 against their plain
    versions on bf16 inputs at the processor's shapes on the real cluster
    layout: out, dq, dk and dv within BF16_TOL of their max, lse within
    K3A_TOL. Times them beside the f32 kernels on the same values (upcast),
    the plain versions and SDPA in bf16 on the gathered unions with the
    adjacency as a boolean mask (timed only). Returns a dict."""
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    nb, u_pad = ids.shape
    n_pad = nb * block
    q, k, v, dout = (torch.randn(1, n_pad, heads, c, generator=gen, device="cuda").bfloat16()
                     for _ in range(4))
    out = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=False)[0]
    out_l, lse = clustered_flash._forward_cuda(q, k, v, ids, masks, block, with_lse=True)
    args = (q, k, v, ids, masks, out_l, lse, dout, block)
    sym = clustered_flash._backward_cuda(*args, True, None)
    before = clustered_flash.BF16_GENERAL_BWD_LAUNCHES
    general = clustered_flash._backward_cuda(*args, False, scatter)
    k3b_launches = clustered_flash.BF16_GENERAL_BWD_LAUNCHES - before
    if k3b_launches != 1:
        raise AssertionError(f"the bf16 general backward made {k3b_launches} K3b launches, expected 1")
    torch.cuda.synchronize()
    ref, ref_lse = clustered_flash.clustered_flash_forward_reference(q, k, v, ids, masks, block,
                                                                     with_lse=True)
    want = clustered_flash.clustered_flash_backward_reference(*args, symmetric=False)
    fwd = [bf16_err(out, ref), bf16_err(out_l, ref)]
    errs = {
        "k3a": max(fwd, key=lambda e: e[1]),
        "k3c": max((bf16_err(a, b) for a, b in zip(sym, want)), key=lambda e: e[1]),
        "k3b": max((bf16_err(a, b) for a, b in zip(general, want)), key=lambda e: e[1]),
    }
    lse_err = (lse - ref_lse).abs().max().item()
    empty = ~masks.reshape(n_pad, -1).bool().any(-1)  # no neighbour, or padding
    zeros = all(bool((t[:, empty] == 0).all()) for t in (out, out_l, *sym, *general))
    dtypes = {t.dtype for t in (out, out_l, *sym, *general)} == {torch.bfloat16}
    wide = [t.float() for t in (q, k, v, dout)]
    out32, lse32 = clustered_flash._forward_cuda(*wide[:3], ids, masks, block, with_lse=True)
    args32 = (*wide[:3], ids, masks, out32, lse32, wide[3], block)
    ms = {
        "k3a": cuda_ms(lambda: clustered_flash._forward_cuda(q, k, v, ids, masks, block, False)),
        "k3a_lse": cuda_ms(lambda: clustered_flash._forward_cuda(q, k, v, ids, masks, block, True)),
        "k3c": cuda_ms(lambda: clustered_flash._backward_cuda(*args, True, None)),
        "k3b": cuda_ms(lambda: clustered_flash._backward_cuda(*args, False, scatter)),
    }
    f32_ms = {
        "k3a": cuda_ms(lambda: clustered_flash._forward_cuda(*wide[:3], ids, masks, block, False)),
        "k3c": cuda_ms(lambda: clustered_flash._backward_cuda(*args32, True, None)),
        "k3b": cuda_ms(lambda: clustered_flash._backward_cuda(*args32, False, scatter)),
    }
    plain_ms = {
        "k3a": cuda_ms(lambda: clustered_flash.clustered_flash_forward_reference(
            q, k, v, ids, masks, block)),
        "k3c": cuda_ms(lambda: clustered_flash.clustered_flash_backward_reference(*args, symmetric=True)),
        "k3b": cuda_ms(lambda: clustered_flash.clustered_flash_backward_reference(*args, symmetric=False)),
    }
    # The library yardstick, in bf16 (gathers outside the timing; rows
    # without a neighbour give NaN there, so it is timed, never compared).
    q_b = q.reshape(nb, block, heads, c).transpose(1, 2).detach().requires_grad_(True)
    k_b, v_b = (t[0, ids.long()].transpose(1, 2).detach().requires_grad_(True) for t in (k, v))
    attend = masks.bool()[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        sdpa_ms = cuda_ms(lambda: sdpa(q_b, k_b, v_b, attn_mask=attend))
    o_b = sdpa(q_b, k_b, v_b, attn_mask=attend)
    do_b = dout.reshape(nb, block, heads, c).transpose(1, 2)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(o_b, (q_b, k_b, v_b), do_b, retain_graph=True))
    ctas = {kind: (clustered_flash.ctas_per_sm(kind, c, block, u_pad, torch.float32),
                   clustered_flash.ctas_per_sm(kind, c, block, u_pad, torch.bfloat16))
            for kind in ("forward", "dq", "symmetric_dkv", "general_dkv")}
    print(
        f"[k3_bf16] c={c}: max_abs_err / 2^-6 max K3a {errs['k3a'][1]:.3f} K3c {errs['k3c'][1]:.3f} "
        f"K3b {errs['k3b'][1]:.3f} (abs {errs['k3a'][0]:.3e} {errs['k3c'][0]:.3e} "
        f"{errs['k3b'][0]:.3e}) | lse {lse_err:.3e} | empty_rows {int(empty.sum())} zeros={zeros} "
        f"bf16 outputs={dtypes} | bf16 ms K3a {ms['k3a']:.4f} (with lse {ms['k3a_lse']:.4f}) "
        f"K3c {ms['k3c']:.4f} K3b {ms['k3b']:.4f} | f32 kernels on the same values K3a "
        f"{f32_ms['k3a']:.4f} K3c {f32_ms['k3c']:.4f} K3b {f32_ms['k3b']:.4f} | plain K3a "
        f"{plain_ms['k3a']:.4f} K3c {plain_ms['k3c']:.4f} K3b {plain_ms['k3b']:.4f} | SDPA bf16 "
        f"{sdpa_ms:.4f} backward {sdpa_bwd_ms:.4f} | CTAs an SM (f32, bf16) "
        + " ".join(f"{kind} {v}" for kind, v in ctas.items()),
        flush=True,
    )
    for name, (_, ratio) in errs.items():
        if not (ratio <= 1.0):
            raise AssertionError(f"{name} bf16 c={c}: max abs error {ratio} x 2^-6 max|plain|")
    if not (lse_err <= K3A_TOL):
        raise AssertionError(f"K3a bf16 c={c}: lse error {lse_err} > {K3A_TOL}")
    if not (zeros and dtypes):
        raise AssertionError(f"K3 bf16 c={c}: empty rows not 0, or outputs not bf16")
    n_edges = khop.senders.shape[0]
    fwd_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, ids, masks, out))
    bwd_bytes = sum(t.numel() * t.element_size() for t in (*args[:-1], *sym))
    return dict(errs=errs, lse_err=lse_err, ms=ms, f32_ms=f32_ms, plain_ms=plain_ms,
                sdpa_ms=sdpa_ms, sdpa_bwd_ms=sdpa_bwd_ms, ctas=ctas, k3b_launches=k3b_launches,
                fwd=(4 * n_edges * heads * c, fwd_bytes), bwd=(10 * n_edges * heads * c, bwd_bytes))


def gencast_bf16_phases(port, clustered_flash, build, gen, ref: dict) -> dict:
    """Phases 44-47: GenCast's bf16 policy on the card (see the module
    docstring). `ref` holds what phases 9-16 leave: phase 9's weights,
    requests, last f32 output and request times, phase 11's sample time,
    phase 15's steady step time, and phase 16's weights, batch, objective,
    f32 loss and card gradients. Returns what the kernels' JSON line reads."""
    from graph_weather_tpu_torch.meshes.clustering import build_cluster_scatter_index
    from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph

    blocks = GENCAST["num_blocks"]
    n_lon, n_lat = len(GENCAST["grid_lon"]), len(GENCAST["grid_lat"])
    f_in, f_out = GENCAST["input_features_dim"], GENCAST["output_features_dim"]
    per_eval = {128: blocks - 1, 512: 1}  # launches per denoiser evaluation, by head width

    def per_eval_sum(values):
        return sum(values[c] * n for c, n in per_eval.items())

    # 44. K3a, K3c and K3b in bf16 on the real splits-5 layout (built in phase 2)
    t44 = time.perf_counter()
    print(f"[build] bf16 instantiations of clustered_flash.cu and clustered_flash_bwd.cu "
          f"(phase 2's build) | {tf32_mma_report(build, 'clustered_flash', kind='BF16')} | "
          f"{tf32_mma_report(build, 'clustered_flash_bwd', kind='BF16')}", flush=True)
    graphs = build_graphcast_graphs(
        GENCAST["grid_lon"], GENCAST["grid_lat"], splits=5, num_hops=4,
        add_edge_features_to_khop=False, spatial_sort="rcb",
    )
    khop = DeviceGraph.from_bundle(graphs.khop, "cuda", clustered=True)
    scatter = torch.as_tensor(build_cluster_scatter_index(
        khop.cluster_ids.cpu().numpy(), khop.cluster_masks.cpu().numpy(), khop.n_senders
    ), device="cuda")
    k3_16 = {c: k3_bf16_case(clustered_flash, khop, scatter, gen, c) for c in (128, 512)}
    k3b16_phase44 = sum(v["k3b_launches"] for v in k3_16.values())  # the checked calls
    del graphs, khop, scatter

    def per_eval16(key, field):
        return per_eval_sum({c: v[field][key] for c, v in k3_16.items()})

    def per_eval16_bound(field):
        by = {c: bf16_bound(*v[field]) for c, v in k3_16.items()}
        return per_eval_sum({c: b[0] for c, b in by.items()}), by[128][1]

    k3a16_bound, k3a16_by = per_eval16_bound("fwd")
    bwd16_bound, bwd16_by = per_eval16_bound("bwd")
    k3a16_sdpa = per_eval_sum({c: v["sdpa_ms"] for c, v in k3_16.items()})
    bwd16_sdpa = per_eval_sum({c: v["sdpa_bwd_ms"] for c, v in k3_16.items()})
    print(f"[k3_bf16] per denoiser eval / train step (15 x c=128 + c=512): K3a bf16 "
          f"{per_eval16('k3a', 'ms'):.4f} ms (f32 {per_eval16('k3a', 'f32_ms'):.4f}, plain "
          f"{per_eval16('k3a', 'plain_ms'):.4f}, SDPA bf16 {k3a16_sdpa:.4f}, bound {k3a16_bound:.4f} "
          f"{k3a16_by}) | K3c bf16 {per_eval16('k3c', 'ms'):.4f} (f32 {per_eval16('k3c', 'f32_ms'):.4f}, "
          f"plain {per_eval16('k3c', 'plain_ms'):.4f}) K3b bf16 {per_eval16('k3b', 'ms'):.4f} (f32 "
          f"{per_eval16('k3b', 'f32_ms'):.4f}, plain {per_eval16('k3b', 'plain_ms'):.4f}), SDPA bf16 "
          f"backward {bwd16_sdpa:.4f}, bound {bwd16_bound:.4f} {bwd16_by} | phase "
          f"{time.perf_counter() - t44:.1f} s", flush=True)

    # 45. bf16 serving: phase 9's weights and requests through forward_fn(bfloat16)
    t45 = time.perf_counter()

    def k3_counts():
        return tuple(getattr(clustered_flash, name) for name in (
            "LAUNCHES", "SYMMETRIC_DQ_LAUNCHES", "SYMMETRIC_DKV_LAUNCHES", "GENERAL_BWD_LAUNCHES",
            "BF16_LAUNCHES", "BF16_SYMMETRIC_DQ_LAUNCHES", "BF16_SYMMETRIC_DKV_LAUNCHES",
            "BF16_GENERAL_BWD_LAUNCHES"))

    def zero_k3_counts():
        for name in ("LAUNCHES", "SYMMETRIC_DQ_LAUNCHES", "SYMMETRIC_DKV_LAUNCHES",
                     "GENERAL_BWD_LAUNCHES", "BF16_LAUNCHES", "BF16_SYMMETRIC_DQ_LAUNCHES",
                     "BF16_SYMMETRIC_DKV_LAUNCHES", "BF16_GENERAL_BWD_LAUNCHES"):
            setattr(clustered_flash, name, 0)

    den16 = port.Denoiser(**GENCAST, device="cuda")
    den16.module.load_state_dict(ref["weights9"])
    serve16 = torch.no_grad()(den16.forward_fn(compute_dtype=torch.bfloat16))
    corrupted, prev, sigma = ref["requests9"]
    torch.cuda.reset_peak_memory_stats()
    zero_k3_counts()
    serve16_ms = []
    for x, cond in zip(corrupted, prev):
        before = k3_counts()
        out16, ms = timed(lambda: serve16(x, cond, sigma))
        serve16_ms.append(ms)
        made = tuple(a - b for a, b in zip(k3_counts(), before))
        if made != (0, 0, 0, 0, blocks, 0, 0, 0):
            raise AssertionError(f"a bf16 request made {made} K3 launches (f32, then bf16), "
                                 f"expected {blocks} bf16 K3a launches and nothing else")
        if out16.dtype != torch.float32 or out16.shape != (1, n_lon, n_lat, f_out) \
                or not torch.isfinite(out16).all():
            raise AssertionError(f"bad bf16 denoiser output: {out16.dtype} {tuple(out16.shape)}")
    serve16_launches = clustered_flash.BF16_LAUNCHES
    serve16_peak = torch.cuda.max_memory_allocated() / 2**30
    b4_gen = torch.Generator().manual_seed(6)
    x4 = torch.randn(4, n_lon, n_lat, f_out, generator=b4_gen).to("cuda")
    cond4 = torch.randn(4, n_lon, n_lat, 2 * f_in, generator=b4_gen).to("cuda")
    sigma4 = torch.ones(4, 1, device="cuda")
    b4_ms = [timed(lambda: serve16(x4, cond4, sigma4))[1] for _ in range(2)]
    print(f"[serve_bf16] request_ms (B=1) {[round(t, 3) for t in serve16_ms]} | bf16 K3a launches "
          f"{serve16_launches} (f32 K3 0) | B=4 request_ms {[round(t, 3) for t in b4_ms]} = "
          f"{b4_ms[-1] / 4:.3f} ms per sample | peak GiB {serve16_peak:.2f} | f32 request_ms "
          f"(phase 9) {[round(t, 3) for t in ref['denoise_ms']]} | earlier bf16 request_ms "
          f"{GENCAST_BF16_EARLIER_MS['request']}", flush=True)
    profile_request(lambda: serve16(x, cond, sigma), "bf16 request")
    cpu16 = port.Denoiser(**GENCAST, device="cpu")
    cpu16.module.load_state_dict(ref["weights9"])
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_out16 = cpu16.forward_fn(compute_dtype=torch.bfloat16)(x.cpu(), cond.cpu(), sigma.cpu())
    cpu_s = time.perf_counter() - t0
    to_cpu = rmse(out16.cpu(), cpu_out16)
    to_f32 = rmse(out16.cpu(), ref["out9"])  # the card's f32 output of the same request
    # The CPU's own reading: the same request with one bf16 ulp added to a
    # random 1 in 2,000 of the corrupted targets' elements.
    flipped, n_flips = one_ulp_off(x, 8)
    with torch.no_grad():
        cpu_flipped = cpu16.forward_fn(compute_dtype=torch.bfloat16)(flipped, cond.cpu(), sigma.cpu())
    print(f"[cpu] bf16 denoiser: RMSE card bf16 - CPU bf16 {to_cpu:.4e} | RMSE card bf16 - card f32 "
          f"{to_f32:.4e} | ratio {to_cpu / to_f32:.3f} (limit {BF16_CARD_RULE}) | CPU bf16 against "
          f"itself with {n_flips} inputs one ulp off {rmse(cpu_out16, cpu_flipped) / to_f32:.3f} "
          f"| max |card - CPU| {(out16.cpu() - cpu_out16).abs().max().item():.3e} | cpu bf16 forward "
          f"{cpu_s:.2f} s | phase {time.perf_counter() - t45:.1f} s", flush=True)
    if not (to_cpu <= BF16_CARD_RULE * to_f32):
        raise AssertionError(f"bf16 denoiser card vs CPU: RMSE {to_cpu} > {BF16_CARD_RULE} x {to_f32}")
    del cpu16, cpu_out16, cpu_flipped, x4, cond4

    # 46. a bf16 20-step sample and a 2-step AR rollout
    sampler16 = port.Sampler(num_steps=20, device="cuda")
    noise16 = torch.Generator(device="cuda").manual_seed(7)
    before = k3_counts()
    sample16, sample16_ms = timed(lambda: sampler16.sample(den16, prev[0], noise16,
                                                           compute_dtype=torch.bfloat16))
    made = tuple(a - b for a, b in zip(k3_counts(), before))
    if made != (0, 0, 0, 0, EVALS_PER_SAMPLE * blocks, 0, 0, 0):
        raise AssertionError(f"a bf16 sample made {made} K3 launches, expected 592 bf16 K3a")
    ar16 = port.make_ar_rollout_fn(sampler16, den16, 2, compute_dtype=torch.bfloat16, device="cuda")
    traj16, ar16_ms = timed(lambda: ar16(prev[0], noise16))
    for name, t, shape in (("sample", sample16, (1, n_lon, n_lat, f_out)),
                           ("rollout", traj16, (2, 1, n_lon, n_lat, f_out))):
        if t.shape != shape or t.dtype != torch.float32 or not torch.isfinite(t).all():
            raise AssertionError(f"bad bf16 {name}: {t.dtype} {tuple(t.shape)}")
    print(f"[sample_bf16] 20 steps ({EVALS_PER_SAMPLE} evals) finite | sample_ms {sample16_ms:.3f} "
          f"(f32, phase 11: {ref['sample_ms']:.3f}; earlier bf16 {GENCAST_BF16_EARLIER_MS['sample']}) "
          f"| ms per eval {sample16_ms / EVALS_PER_SAMPLE:.3f} | "
          f"bf16 K3a launches {made[4]} | 2-step AR rollout ms per AR step {ar16_ms / 2:.3f}",
          flush=True)
    del sampler16, ar16, traj16

    # 47. bf16 training: 3 steps of bench.py's gencast_train objective
    t47 = time.perf_counter()
    corrupted_t, prev_t, _, target_t = ref["batch16"]  # phase 15's batch
    noise1 = torch.ones(1, 1, device="cuda")  # bench.py's noise level

    def mse(pred, target):
        return torch.mean((pred - target) ** 2)

    step16 = port.make_train_step(den16.module.parameters(),
                                  den16.forward_fn(compute_dtype=torch.bfloat16), mse,
                                  port.make_optimizer(1e-4))
    before_params = [t.detach().clone() for t in den16.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    zero_k3_counts()
    train16_ms, train16_losses = [], []
    for _ in range(3):
        before = k3_counts()
        loss, ms = timed(lambda: step16(corrupted_t, prev_t, noise1, target_t))
        made = tuple(a - b for a, b in zip(k3_counts(), before))
        if made != (0, 0, 0, 0, blocks, blocks, blocks, 0):
            raise AssertionError(f"a bf16 train step made {made} K3 launches (f32, then bf16 K3a, "
                                 f"K3c dq, K3c dk/dv, K3b), expected 16 of each bf16 K3a/K3c kernel")
        if not torch.isfinite(loss):
            raise AssertionError(f"bf16 train loss {loss.item()}")
        train16_ms.append(ms)
        train16_losses.append(loss.item())
    train16_launches = k3_counts()
    train16_peak = torch.cuda.max_memory_allocated() / 2**30
    params16 = list(den16.module.parameters())
    if any(t.dtype != torch.float32 for t in params16):
        raise AssertionError("a parameter left f32 under the bf16 policy")
    unchanged = sum(torch.equal(a, b) for a, b in zip(before_params, params16))
    if unchanged:
        raise AssertionError(f"{unchanged} parameter tensors did not change in 3 bf16 train steps")
    print(f"[train_bf16] 3 steps | step_ms {[round(t, 3) for t in train16_ms]} | steady median "
          f"{statistics.median(train16_ms[1:]):.3f} (f32, phase 15: {ref['train_ms']:.3f}; earlier "
          f"bf16 {GENCAST_BF16_EARLIER_MS['step']}) "
          f"| loss {[round(v, 6) for v in train16_losses]} | launches per step bf16 K3a {blocks} "
          f"K3c dq {blocks} K3c dk/dv {blocks} K3b 0, f32 K3 0 | all {len(params16)} f32 parameter "
          f"tensors changed | peak GiB {train16_peak:.2f}", flush=True)
    profile_request(lambda: step16(corrupted_t, prev_t, noise1, target_t), "bf16 train step")
    del step16, before_params
    # The bf16 gradients at phase 16's weights and batch, card and CPU, held
    # against phase 16's f32 gradients on the card.
    den16.module.load_state_dict(ref["weights16"])
    den16.module.zero_grad(set_to_none=True)
    batch16, grads16 = ref["batch16"], ref["grads16"]
    card16_value = ref["objective16"](
        den16.forward_fn(compute_dtype=torch.bfloat16)(*batch16[:3]), batch16[3])
    card16_value.backward()
    card16_grads = {k: t.grad.cpu() for k, t in den16.module.named_parameters()}
    cpu16 = port.Denoiser(**GENCAST, device="cpu")
    cpu16.module.load_state_dict(ref["weights16"])
    cpu_objective = port.WeightedMSELoss(grid_lat=GENCAST["grid_lat"], device="cpu")

    def cpu_grads(corrupted):
        cpu16.module.zero_grad(set_to_none=True)
        value = cpu_objective(
            cpu16.forward_fn(compute_dtype=torch.bfloat16)(corrupted, *(t.cpu() for t in batch16[1:3])),
            batch16[2].cpu(), batch16[3].cpu())
        value.backward()
        return value, {k: t.grad for k, t in cpu16.module.named_parameters()}

    t0 = time.perf_counter()
    cpu16_value, cpu16_grads = cpu_grads(batch16[0].cpu())
    cpu_s = time.perf_counter() - t0
    to_cpu = global_norm({k: card16_grads[k] - cpu16_grads[k] for k in cpu16_grads})
    to_f32 = global_norm({k: card16_grads[k] - grads16[k] for k in grads16})
    # The CPU's own reading, beside a miss only (a second CPU run): its
    # gradients with one bf16 ulp added to 1 in 2,000 of the corrupted
    # targets' elements, against its own.
    own_text = "not taken (within the limit)"
    if not (to_cpu <= BF16_CARD_GRAD_RULE * to_f32):
        flipped, n_flips = one_ulp_off(batch16[0], 9)
        cpu_flipped = cpu_grads(flipped)[1]
        own = global_norm({k: cpu16_grads[k] - cpu_flipped[k] for k in cpu16_grads}) / to_f32
        own_text = f"with {n_flips} inputs one ulp off {own:.3f}"
    print(f"[cpu] bf16 gradients at phase 16's weights and batch: global norm card bf16 - CPU bf16 "
          f"{to_cpu:.4e} | card bf16 - card f32 {to_f32:.4e} | ratio {to_cpu / to_f32:.3f} (limit "
          f"{BF16_CARD_GRAD_RULE}) | CPU bf16 against itself {own_text} "
          f"| |g| {global_norm(card16_grads):.4e} | loss card {card16_value.item():.6f} "
          f"cpu {cpu16_value.item():.6f} f32 (phase 16) {ref['loss16']:.6f} | cpu bf16 "
          f"forward+backward {cpu_s:.2f} s | phase {time.perf_counter() - t47:.1f} s", flush=True)
    if not (to_cpu <= BF16_CARD_GRAD_RULE * to_f32):
        raise AssertionError(f"bf16 gradients card vs CPU: {to_cpu} > {BF16_CARD_GRAD_RULE} x {to_f32}")
    del cpu16, den16, card16_grads, cpu16_grads
    torch.cuda.empty_cache()
    return dict(k3_16=k3_16, k3b16_phase44=k3b16_phase44, serve16_launches=serve16_launches,
                train16_launches=train16_launches, per_eval16=per_eval16, k3a16_bound=k3a16_bound,
                k3a16_by=k3a16_by, bwd16_bound=bwd16_bound, bwd16_by=bwd16_by, k3a16_sdpa=k3a16_sdpa,
                bwd16_sdpa=bwd16_sdpa)


def k2_bf16_case(fused_mlp, name, graph, with_dst, gen, width=256):
    """K2 in bf16 against its plain version on bf16 operands (phase 3's,
    rounded), within BF16_TOL of the plain output's max, and the f32 kernel
    on the same values. Returns a dict."""
    args32 = k2_inputs(graph, with_dst, gen, width)
    args = tuple(t.bfloat16() if t is not None and t.is_floating_point() else t for t in args32)
    args32 = tuple(t.float() if t is not None and t.is_floating_point() else t for t in args)
    tables = dict(sender_sum=graph.sender_sum, receiver_sum=graph.receiver_sum,
                  sender_csr=graph.sender_csr, receiver_csr=graph.receiver_csr)
    out = fused_mlp.fused_edge_update(*args, **tables)
    torch.cuda.synchronize()
    ref = fused_mlp.fused_edge_update_reference(*args)
    err, ratio = bf16_err(out, ref)
    equal = (out == ref).float().mean().item()
    ms = cuda_ms(lambda: fused_mlp.fused_edge_update(*args, **tables))
    f32_ms = cuda_ms(lambda: fused_mlp.fused_edge_update(*args32, **tables))
    plain_ms = cuda_ms(lambda: fused_mlp.fused_edge_update_reference(*args))
    print(f"[k2_bf16] {name}: E={graph.senders.shape[0]} p_dst={'yes' if with_dst else 'None'} "
          f"out {out.dtype} max_abs_err={err:.3e} ({ratio:.3f} of 2^-6 max), bit-equal share "
          f"{equal:.5f} | kernel_ms={ms:.4f} f32 kernel on the same values {f32_ms:.4f} "
          f"plain_ms={plain_ms:.4f}", flush=True)
    if not (ratio <= 1.0 and out.dtype == torch.bfloat16):
        raise AssertionError(f"K2 bf16 {name}: max abs error {ratio} x 2^-6 max|plain|, or not bf16")
    n_edges = graph.senders.shape[0]
    # The bf16 rows each edge gathers (p_src, p_dst) and its e and e' rows.
    nbytes = 2 * n_edges * ((2 if with_dst else 1) * width + 2 * width)
    return dict(err=err, ratio=ratio, ms=ms, f32_ms=f32_ms, plain_ms=plain_ms,
                flops=2 * n_edges * width * 3 * width, nbytes=nbytes)


def k2b_bf16_case(fused_mlp, name, graph, with_dst, gen, width=256):
    """K2b in bf16 with the sums after it (S by sender and receiver) against
    the plain backward on bf16 operands at the kernel's ReLU masks (as
    k2b_case), every gradient within BF16_TOL of its max; the kernel alone,
    the whole backward, the f32 kernel on the same values and the plain
    backward timed. Returns a dict."""
    args = tuple(t.bfloat16() if t is not None and t.is_floating_point() else t
                 for t in k2_inputs(graph, with_dst, gen, width))
    args32 = tuple(t.float() if t is not None and t.is_floating_point() else t for t in args)
    dout = torch.randn(1, graph.senders.shape[0], width, generator=gen, device="cuda").bfloat16()
    tables = (graph.sender_sum, graph.receiver_sum, graph.sender_csr, graph.receiver_csr)
    outs, _ = fused_mlp.launch_backward(*args[:12], dout)
    activations = outs[:2]
    plain = fused_mlp.fused_edge_update_activations(*args[:9])
    act_equal = min((a == p).float().mean().item() for a, p in zip(activations, plain))
    act_ratio = max(bf16_err(a, p.expand(a.shape))[1] for a, p in zip(activations, plain))
    if not (act_ratio <= 1.0):
        raise AssertionError(f"K2b bf16 {name}: recomputed h0/h1 error {act_ratio} x 2^-6 max|plain|")
    del outs, plain
    got = fused_mlp._backward_cuda(*args, dout, *tables)
    torch.cuda.synchronize()
    want = fused_mlp.fused_edge_update_backward_reference(
        *args, dout, *tables[:2], activations=activations, sender_csr=tables[2],
        receiver_csr=tables[3])
    names = ("p_src", "p_dst", "e", "we", "b0", "w1", "b1", "w2", "b2", "gamma", "beta")
    errs = {n: bf16_err(g, w) for n, g, w in zip(names, got, want) if w is not None}
    dtypes = {g.dtype for g in got if g is not None}
    worst = max(errs, key=lambda n: errs[n][1])
    del got, want, activations
    dout32 = dout.float()
    ms = {
        "kernel": cuda_ms(lambda: fused_mlp.launch_backward(*args[:12], dout)),
        "backward": cuda_ms(lambda: fused_mlp._backward_cuda(*args, dout, *tables)),
        "f32_kernel": cuda_ms(lambda: fused_mlp.launch_backward(*args32[:12], dout32)),
        "plain": cuda_ms(lambda: fused_mlp.fused_edge_update_backward_reference(
            *args, dout, *tables[:2], sender_csr=tables[2], receiver_csr=tables[3]), runs=3),
    }
    print(f"[k2b_bf16] {name}: E={graph.senders.shape[0]} p_dst={'yes' if with_dst else 'None'} "
          f"h0/h1 bit-equal share {act_equal:.5f}, error {act_ratio:.3f} of 2^-6 max | worst error {errs[worst][1]:.3f} of 2^-6 max "
          f"({worst}, abs {errs[worst][0]:.3e}) | gradients {sorted(str(d) for d in dtypes)} | "
          f"kernel_ms={ms['kernel']:.4f} backward_ms={ms['backward']:.4f} f32 kernel on the same "
          f"values {ms['f32_kernel']:.4f} plain_ms={ms['plain']:.4f}", flush=True)
    if not (errs[worst][1] <= 1.0 and dtypes == {torch.bfloat16}):
        raise AssertionError(f"K2b bf16 {name}: {worst} error {errs[worst][1]} x 2^-6 max, or not bf16")
    n_edges = graph.senders.shape[0]
    nbytes = 2 * n_edges * (((2 if with_dst else 1) + 4) * width + 4 * width)  # as k2b_case, bf16
    return dict(err=errs[worst][0], ratio=errs[worst][1], ms=ms,
                flops=2 * n_edges * width * 6 * width, nbytes=nbytes)


def s_case(segment_sums, name, graph, gen, width=256):
    """S against its plain version on bf16 edge rows [1, E, width] summed to
    the graph's receivers and to its senders: bit-equal. Times S, the plain
    version and index_add_ in bf16 (its atomics add in another order: timed
    only). Returns {direction: dict}."""
    rows = torch.randn(1, graph.senders.shape[0], width, generator=gen, device="cuda").bfloat16()
    out = {}
    for direction, csr, nodes in (("receivers", graph.receiver_csr, graph.receivers),
                                  ("senders", graph.sender_csr, graph.senders)):
        counts = (csr[0][1:] - csr[0][:-1]).cpu()
        max_degree = int(counts.max())
        got = segment_sums.segment_sum_bf16(rows, *csr)
        torch.cuda.synchronize()
        want = segment_sums.edge_order_sum_reference(rows, *csr)
        equal = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        target = torch.zeros_like(got)
        index = nodes.long()
        ms = cuda_ms(lambda: segment_sums.segment_sum_bf16(rows, *csr))
        plain_ms = cuda_ms(lambda: segment_sums.edge_order_sum_reference(rows, *csr),
                           runs=3)
        library_ms = cuda_ms(lambda: target.index_add_(-2, index, rows))
        n_nodes, n_edges = counts.shape[0], rows.shape[1]
        print(f"[s] {name} to the {direction}: N={n_nodes} E={n_edges} max degree {max_degree} | "
              f"bit-equal {equal} | kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} index_add_ bf16 "
              f"{library_ms:.4f}", flush=True)
        if not equal:
            raise AssertionError(f"S {name} {direction}: not bit-equal to its plain version")
        # Each edge row read once, each node row written once, the flat CSR.
        nbytes = 2 * (n_edges + n_nodes) * width + 4 * (n_nodes + 1 + n_edges)
        out[direction] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              flops=n_edges * width, nbytes=nbytes)
    return out


def forecaster_bf16_phases(port, fused_mlp, edge_mlp, segment_sums, build, gen, ref: dict) -> dict:
    """Phases 48-50: the forecaster's bf16 policy on the card (see the module
    docstring). `ref` holds the 1° grid and graphs (phase 3), phase 4's
    requests, times and profiled kernel count, and phase 34's batch, step
    time and profiled kernel count. Returns what the kernels' JSON line
    reads."""
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.train.rollout import make_rollout_fn

    lat_lons = ref["lat_lons"]
    n_grid = len(lat_lons)

    def per_forward(values):
        return sum(values[n] * c for n, c in EDGE_UPDATES.items())

    # 48. K2, K2b and S in bf16 at the main-path shapes (built in phase 2)
    t48 = time.perf_counter()
    print(f"[build] bf16 K2 and K2b (phase 2's build of edge_mlp.cu, fused_mlp_bwd.cu; S: "
          f"segment_sum_bf16.cu) | {tf32_mma_report(build, 'edge_mlp', kind='BF16')} | "
          f"{tf32_mma_report(build, 'fused_mlp_bwd', kind='BF16')} | segment_sum_bf16.cu: "
          + " | ".join(ptxas_by_kernel(build, "segment_sum_bf16")), flush=True)
    graphs = {name: DeviceGraph.from_bundle(bundle, "cuda", edge_sums=True)
              for name, bundle in ref["bundles"].items()}
    k2_16 = {n: k2_bf16_case(fused_mlp, n, graphs[n], n != "m2g", gen) for n in EDGE_UPDATES}
    k2b_16 = {n: k2b_bf16_case(fused_mlp, n, graphs[n], n != "m2g", gen) for n in EDGE_UPDATES}
    s16 = {n: s_case(segment_sums, n, graphs[n], gen) for n in EDGE_UPDATES}
    del graphs
    torch.cuda.empty_cache()
    # S per train step: the g2m aggregation and the node terms' gradients
    # (g2m receivers twice, its senders, each latent graph's both sides, the
    # m2g senders); per request the aggregation alone.
    s_step = {("g2m", "receivers"): 2, ("g2m", "senders"): 1, ("latent", "receivers"): 9,
              ("latent", "senders"): 9, ("m2g", "senders"): 1}

    def s_sum(field):
        return sum(s16[g][d][field] * c for (g, d), c in s_step.items())

    def s_bound():
        return sum(bf16_bound(s16[g][d]["flops"], s16[g][d]["nbytes"])[0] * c
                   for (g, d), c in s_step.items())

    k2_16_bound = per_forward({n: bf16_bound(v["flops"], v["nbytes"])[0] for n, v in k2_16.items()})
    k2_16_by = bf16_bound(k2_16["m2g"]["flops"], k2_16["m2g"]["nbytes"])[1]
    k2b_16_bound = per_forward({n: bf16_bound(v["flops"], v["nbytes"])[0] for n, v in k2b_16.items()})
    k2b_16_by = bf16_bound(k2b_16["m2g"]["flops"], k2b_16["m2g"]["nbytes"])[1]
    out = dict(
        k2=dict(ms=per_forward({n: v["ms"] for n, v in k2_16.items()}),
                f32_ms=per_forward({n: v["f32_ms"] for n, v in k2_16.items()}),
                plain_ms=per_forward({n: v["plain_ms"] for n, v in k2_16.items()}),
                bound_ms=k2_16_bound, bound_by=k2_16_by,
                err=max(v["err"] for v in k2_16.values()),
                ratio=max(v["ratio"] for v in k2_16.values()),
                gflop=per_forward({n: v["flops"] for n, v in k2_16.items()}) / 1e9,
                gb=per_forward({n: v["nbytes"] for n, v in k2_16.items()}) / 1e9),
        k2b=dict(ms=per_forward({n: v["ms"]["kernel"] for n, v in k2b_16.items()}),
                 backward_ms=per_forward({n: v["ms"]["backward"] for n, v in k2b_16.items()}),
                 f32_ms=per_forward({n: v["ms"]["f32_kernel"] for n, v in k2b_16.items()}),
                 plain_ms=per_forward({n: v["ms"]["plain"] for n, v in k2b_16.items()}),
                 bound_ms=k2b_16_bound, bound_by=k2b_16_by,
                 err=max(v["err"] for v in k2b_16.values()),
                 ratio=max(v["ratio"] for v in k2b_16.values()),
                 gflop=per_forward({n: v["flops"] for n, v in k2b_16.items()}) / 1e9,
                 gb=per_forward({n: v["nbytes"] for n, v in k2b_16.items()}) / 1e9),
        s=dict(err=max(v["err"] for d in s16.values() for v in d.values()),
               ms=s_sum("ms"), plain_ms=s_sum("plain_ms"), library_ms=s_sum("library_ms"),
               bound_ms=s_bound(), bound_by="bytes",
               request_ms=s16["g2m"]["receivers"]["ms"]),
    )
    print(f"[k2_bf16] per forward (g2m + 9 latent + m2g): kernel_ms={out['k2']['ms']:.4f} (f32 kernel "
          f"on the same values {out['k2']['f32_ms']:.4f}) plain_ms={out['k2']['plain_ms']:.4f} "
          f"bound_ms={k2_16_bound:.4f} ({k2_16_by}: {out['k2']['gflop']:.1f} GFLOP, "
          f"{out['k2']['gb']:.2f} GB) | K2b bf16 per train step kernel_ms={out['k2b']['ms']:.4f} "
          f"(f32 kernel {out['k2b']['f32_ms']:.4f}) backward_ms={out['k2b']['backward_ms']:.4f} "
          f"plain_ms={out['k2b']['plain_ms']:.4f} bound_ms={k2b_16_bound:.4f} ({k2b_16_by}: "
          f"{out['k2b']['gflop']:.1f} GFLOP, {out['k2b']['gb']:.2f} GB) | S per train step (22 "
          f"launches) kernel_ms={out['s']['ms']:.4f} plain_ms={out['s']['plain_ms']:.4f} index_add_ "
          f"bf16 {out['s']['library_ms']:.4f} bound_ms={out['s']['bound_ms']:.4f} (bytes) | phase "
          f"{time.perf_counter() - t48:.1f} s", flush=True)

    def counts():
        return (fused_mlp.LAUNCHES, fused_mlp.BF16_LAUNCHES, fused_mlp.BACKWARD_LAUNCHES,
                fused_mlp.BF16_BACKWARD_LAUNCHES, edge_mlp.LAUNCHES, segment_sums.LAUNCHES)

    def zero_counts():
        fused_mlp.LAUNCHES = fused_mlp.BF16_LAUNCHES = fused_mlp.BACKWARD_LAUNCHES = 0
        fused_mlp.BF16_BACKWARD_LAUNCHES = edge_mlp.LAUNCHES = segment_sums.LAUNCHES = 0

    # 49. fc_serve_bf16: phase 4's weights and requests through forward_fn(bfloat16)
    t49 = time.perf_counter()
    model = port.GraphWeatherForecaster(lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM,
                                        device="cuda")
    model.init(torch.Generator().manual_seed(0))  # phase 4's weights
    serve16 = torch.no_grad()(model.forward_fn(compute_dtype=torch.bfloat16))
    per_request = (0, 11, 0, 0, 0, 1)  # (K2, K2 bf16, K2b, K2b bf16, K1, S)
    zero_counts()
    serve_ms = []
    for features in ref["inputs"]:
        before = counts()
        pred16, ms = timed(lambda: serve16(features))
        made = tuple(a - b for a, b in zip(counts(), before))
        if made != per_request:
            raise AssertionError(f"a bf16 forecaster request made {made} (K2, K2 bf16, K2b, K2b bf16, "
                                 f"K1, S) launches, expected {per_request}")
        if pred16.dtype != torch.float32 or pred16.shape != (1, n_grid, FEATURE_DIM) \
                or not torch.isfinite(pred16).all():
            raise AssertionError(f"bad bf16 prediction: {pred16.dtype} {tuple(pred16.shape)}")
        serve_ms.append(ms)
    serve16_launches = counts()
    kernels16 = profile_request(lambda: serve16(features), "bf16 forecaster request")
    kernels32 = ref["request_kernels"]
    print(f"[fc_serve_bf16] request_ms (B=1) {[round(t, 3) for t in serve_ms]} | f32 (phase 4) "
          f"{[round(t, 3) for t in ref['request_ms']]} | launches per request bf16 K2 11, S 1, f32 K2 "
          f"0, K1 0 | kernels per request bf16 {kernels16}, f32 (phase 4) {kernels32}", flush=True)
    if kernels16 is None or kernels32 is None:
        raise AssertionError("the profiler recorded no device kernels: the bf16 request's kernel count "
                             "against f32's is not measured")
    if not kernels16 <= 1.5 * kernels32:
        raise AssertionError(f"a bf16 request launched {kernels16} kernels, over 1.5 x f32's {kernels32}")
    rollout = make_rollout_fn(model.forward_fn(compute_dtype=torch.bfloat16), 4)
    before = counts()
    traj, ms = timed(lambda: rollout(ref["inputs"][0]))
    made = tuple(a - b for a, b in zip(counts(), before))
    if traj.shape != (4, 1, n_grid, FEATURE_DIM) or traj.dtype != torch.float32 \
            or not torch.isfinite(traj).all() or made != tuple(4 * c for c in per_request):
        raise AssertionError(f"bad bf16 rollout: {traj.dtype} {tuple(traj.shape)}, launches {made}")
    print(f"[fc_serve_bf16] 4-step rollout finite | ms per step {ms / 4:.3f} | bf16 K2 44, S 4", flush=True)
    del traj, rollout
    with torch.no_grad():
        pred32 = model.forward_fn()(features)  # the card's f32 output of the same request
    cpu = port.GraphWeatherForecaster(lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in model.module.state_dict().items()})
    cpu16 = torch.no_grad()(cpu.forward_fn(compute_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    cpu_pred16 = cpu16(features.cpu())
    cpu_s = time.perf_counter() - t0
    flipped, n_flips = one_ulp_off(features, 10)
    to_cpu = rmse(pred16.cpu(), cpu_pred16)
    to_f32 = rmse(pred16.cpu(), pred32.cpu())
    own = rmse(cpu_pred16, cpu16(flipped)) / to_f32
    limit = max(FC_BF16_RULE, own)
    print(f"[cpu] bf16 forecaster at 1°: RMSE card bf16 - CPU bf16 {to_cpu:.4e} | card bf16 - card "
          f"f32 {to_f32:.4e} | ratio {to_cpu / to_f32:.3f} (limit {limit:.3f}: the larger of "
          f"{FC_BF16_RULE} and the CPU's own reading) | CPU bf16 against itself with {n_flips} inputs "
          f"one ulp off {own:.3f} | max |card - CPU| {(pred16.cpu() - cpu_pred16).abs().max().item():.3e} "
          f"| cpu bf16 forward {cpu_s:.2f} s | phase {time.perf_counter() - t49:.1f} s", flush=True)
    if not (to_cpu <= limit * to_f32):
        raise AssertionError(f"bf16 forecaster card vs CPU: RMSE {to_cpu} > {limit} x {to_f32}")
    del cpu, cpu16, cpu_pred16, pred32, serve16

    # 50. fc_train_bf16: 3 steps of bench.py's bf16 train_step objective
    t50 = time.perf_counter()
    x, y = ref["batch"]
    loss_fn = port.NormalizedMSELoss(np.ones(FEATURE_DIM), lat_lons, normalize=True, device="cuda")
    step = port.make_train_step(model.module.parameters(),
                                model.forward_fn(compute_dtype=torch.bfloat16), loss_fn,
                                port.make_optimizer(1e-3))
    per_step = (0, 11, 0, 11, 0, 22)
    before_params = [t.detach().clone() for t in model.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_ms, losses = [], []
    for _ in range(3):
        before = counts()
        loss, ms = timed(lambda: step(x, y))
        made = tuple(a - b for a, b in zip(counts(), before))
        if made != per_step:
            raise AssertionError(f"a bf16 forecaster train step made {made} (K2, K2 bf16, K2b, K2b "
                                 f"bf16, K1, S) launches, expected {per_step}")
        if not torch.isfinite(loss):
            raise AssertionError(f"bf16 forecaster train loss {loss.item()}")
        step_ms.append(ms)
        losses.append(loss.item())
    train16_launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = list(model.module.parameters())
    if any(t.dtype != torch.float32 for t in params):
        raise AssertionError("a forecaster parameter left f32 under the bf16 policy")
    moments = [t for state in step.optimizer.state.values() for t in state.values()
               if torch.is_tensor(t) and t.dim() > 0]
    if any(t.dtype != torch.float32 for t in moments):
        raise AssertionError("the optimizer's moments left f32 under the bf16 policy")
    unchanged = sum(torch.equal(a, b) for a, b in zip(before_params, params))
    if unchanged:
        raise AssertionError(f"{unchanged} forecaster parameter tensors did not change in 3 bf16 steps")
    step_kernels = profile_request(lambda: step(x, y), "bf16 forecaster train step")
    print(f"[fc_train_bf16] 3 steps | step_ms {[round(t, 3) for t in step_ms]} | steady median "
          f"{statistics.median(step_ms[1:]):.3f} (f32, phase 34: {ref['train_ms']:.3f}) | loss "
          f"{[round(v, 6) for v in losses]} | launches per step bf16 K2 11, bf16 K2b 11, S 22, f32 "
          f"K2/K2b 0, K1 0 | all {len(params)} f32 parameter tensors changed, f32 moments | peak GiB "
          f"{peak:.2f} | kernels per step bf16 {step_kernels}, f32 (phase 34) {ref['step_kernels']}",
          flush=True)
    del step, before_params, moments

    def grads(handle, loss, dtype, inputs, targets):
        handle.module.zero_grad(set_to_none=True)
        value = loss(handle.forward_fn(compute_dtype=dtype)(inputs), targets)
        value.backward()
        return value.item(), {k: t.grad.cpu() for k, t in handle.module.named_parameters()}

    # The same weights and batch twice on the card: the loss and gradients
    # repeat bit for bit (S, K2b and the table sums add in a fixed order).
    card_value, card16 = grads(model, loss_fn, torch.bfloat16, x, y)
    again_value, again = grads(model, loss_fn, torch.bfloat16, x, y)
    differ = [k for k in card16 if not torch.equal(card16[k], again[k])]
    if card_value != again_value or differ:
        raise AssertionError(f"the card's repeated bf16 forecaster loss ({card_value!r}, "
                             f"{again_value!r}) or gradients differ: {len(differ)} tensors, {differ[:8]}")
    del again
    f32_value, card32 = grads(model, loss_fn, torch.float32, x, y)
    cpu = port.GraphWeatherForecaster(lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cpu")
    cpu.module.load_state_dict({k: v.cpu() for k, v in model.module.state_dict().items()})
    cpu_loss = port.NormalizedMSELoss(np.ones(FEATURE_DIM), lat_lons, normalize=True, device="cpu")
    t0 = time.perf_counter()
    cpu_value, cpu16_grads = grads(cpu, cpu_loss, torch.bfloat16, x.cpu(), y.cpu())
    cpu_s = time.perf_counter() - t0
    to_cpu = global_norm({k: card16[k] - cpu16_grads[k] for k in card16})
    to_f32 = global_norm({k: card16[k] - card32[k] for k in card16})
    own, own_text = 0.0, "not needed (within 0.5)"  # a second CPU run, where the card misses 0.5
    if not (to_cpu <= FC_BF16_RULE * to_f32):
        flipped, n_flips = one_ulp_off(x, 11)
        cpu_flipped = grads(cpu, cpu_loss, torch.bfloat16, flipped, y.cpu())[1]
        own = global_norm({k: cpu16_grads[k] - cpu_flipped[k] for k in card16}) / to_f32
        own_text = f"with {n_flips} inputs one ulp off {own:.3f}"
    limit = max(FC_BF16_RULE, own)
    print(f"[cpu] bf16 forecaster gradients at 1° after the steps: global norm card bf16 - CPU bf16 "
          f"{to_cpu:.4e} | card bf16 - card f32 {to_f32:.4e} | ratio {to_cpu / to_f32:.3f} (limit "
          f"{limit:.3f}) | CPU bf16 against itself {own_text} | card "
          f"repeat bit-equal True | loss card {card_value:.6f} cpu {cpu_value:.6f} f32 {f32_value:.6f} "
          f"| |g| {global_norm(card16):.4e} | cpu bf16 forward+backward {cpu_s:.2f} s | phase "
          f"{time.perf_counter() - t50:.1f} s", flush=True)
    if not (to_cpu <= limit * to_f32):
        raise AssertionError(f"bf16 forecaster gradients card vs CPU: {to_cpu} > {limit} x {to_f32}")
    del cpu, model, card16, card32, cpu16_grads
    torch.cuda.empty_cache()
    out.update(serve16_launches=serve16_launches, train16_launches=train16_launches)
    return out


def natten_inputs(gen, kernel, heads, ch=32, dims=WM_LATENT):
    """q, k, v [1, D, H, W, heads, ch] as views of one fused qkv tensor (the
    model's layout), rpb ~N(0, 0.5^2)."""
    shape = (1, *dims)
    qkv = torch.randn(*shape, 3 * heads * ch, generator=gen, device="cuda")
    q, k, v = (t.reshape(*shape, heads, ch) for t in qkv.chunk(3, dim=-1))
    rpb = 0.5 * torch.randn(heads, *(2 * kk - 1 for kk in kernel), generator=gen, device="cuda")
    return q, k, v, rpb


def natten_sdpa_inputs(natten_flash, q, k, v, kernel, rpb, circular, grads=None):
    """The library yardstick's inputs: K5a's tiles, each query tile with its
    gathered K/V halo [n_tiles, heads, rows, ch] and the window mask and rpb
    folded into one additive float mask [n_tiles, heads, TQ, U] (-inf off
    the window). Padded query rows copy the volume's last row. `grads` (dO)
    is tiled like q. Built on the card, outside any timing."""
    _, d, h, w, heads, ch = q.shape
    tile = natten_flash._pick_tile("fwd", (d, h, w), kernel, circular, ch, True)
    dev = q.device
    axes = []
    for size, kk, t, u, circ in zip((d, h, w), kernel, (tile.td, tile.th, tile.tw),
                                    (tile.ud, tile.uh, tile.uw), (False, False, circular)):
        starts = list(range(0, size, t))
        spans = [natten_flash._window_span(i0, min(i0 + t, size), size, kk, circ) for i0 in starts]
        qpos = (torch.tensor(starts, device=dev)[:, None] + torch.arange(t, device=dev)).clamp(max=size - 1)
        lo = torch.tensor([sp[0] for sp in spans], device=dev)[:, None]
        krow = torch.arange(u, device=dev)
        kpos = lo + krow  # [n, u], unwrapped
        kin = krow[None, :] < torch.tensor([sp[1] for sp in spans], device=dev)[:, None]
        qq, kp = qpos[:, :, None], kpos[:, None, :]
        if circ:
            z = torch.remainder(kp - qq + kk // 2, size)
            member, rel = z < kk, z - kk // 2 + kk - 1
        else:
            start = (qq - kk // 2).clamp(0, size - kk)
            member, rel = (kp >= start) & (kp < start + kk), kp - qq + kk - 1
        axes.append((qpos, torch.remainder(kpos, size), member & kin[:, None, :],
                     rel.clamp(0, 2 * kk - 2)))
    (qd, kd_, md, rd), (qh, kh_, mh, rh), (qw, kw_, mw, rw) = axes
    nd, nh, nw = qd.shape[0], qh.shape[0], qw.shape[0]

    def outer(a, b, c):  # [n, x] per axis -> [n_tiles, x_d * x_h * x_w]
        t = a[:, None, None, :, None, None] + b[None, :, None, None, :, None] + c[None, None, :, None, None, :]
        return t.reshape(nd * nh * nw, -1)

    q_ids = outer(qd * h * w, qh * w, qw)  # flat positions
    k_ids = outer(kd_ * h * w, kh_ * w, kw_)
    m = (md[:, None, None, :, None, None, :, None, None] & mh[None, :, None, None, :, None, None, :, None]
         & mw[None, None, :, None, None, :, None, None, :])
    n_rel_h, n_rel_w = 2 * kernel[1] - 1, 2 * kernel[2] - 1
    r = ((rd[:, None, None, :, None, None, :, None, None] * n_rel_h
          + rh[None, :, None, None, :, None, None, :, None]) * n_rel_w
         + rw[None, None, :, None, None, :, None, None, :])
    tq, u = q_ids.shape[1], k_ids.shape[1]
    m, r = m.reshape(-1, tq, u), r.reshape(-1, tq, u)
    bias = rpb.reshape(heads, -1)[:, r].permute(1, 0, 2, 3)  # [n_tiles, heads, TQ, U]
    bias = bias.masked_fill(~m[:, None], float("-inf")).contiguous()

    def tiles(t, ids):
        return t.reshape(-1, heads, ch)[ids].permute(0, 2, 1, 3).contiguous()

    out = [tiles(q, q_ids), tiles(k, k_ids), tiles(v, k_ids), bias]
    if grads is not None:
        out.append(tiles(grads, q_ids))
    return out


def k5a_case(natten_flash, reference, name, gen, kernel, heads, circular, ch=32):
    """K5a against its plain version on WeatherMesh's 1-degree latent, and
    its out and lse against a second launch's (bit for bit). Returns a dict
    of errors, times (ms), flops and bytes."""
    q, k, v, rpb = natten_inputs(gen, kernel, heads, ch)
    args = (q, k, v, kernel, rpb, circular)
    out, lse = natten_flash._forward_cuda(*args, with_lse=True)
    again = natten_flash._forward_cuda(*args, with_lse=True)
    torch.cuda.synchronize()
    repeats = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = reference(q, k, v, kernel, rpb, circular, with_lse=True)
    err = max((out - ref).abs().max().item(), (lse - ref_lse).abs().max().item())
    ms = cuda_ms(lambda: natten_flash._forward_cuda(*args, with_lse=False))
    lse_ms = cuda_ms(lambda: natten_flash._forward_cuda(*args, with_lse=True))
    plain_ms = cuda_ms(lambda: reference(*args), runs=3, batch=2)
    qt, kt, vt, bias = natten_sdpa_inputs(natten_flash, *args)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias))
    tile = natten_flash._pick_tile("fwd", WM_LATENT, kernel, circular, ch, True)
    plan = natten_flash._fwd_plan(WM_LATENT, kernel, circular, ch, True)
    print(f"[k5a] {name}: kernel {kernel} heads {heads} x {ch} circular_w={circular} | plan: tile "
          f"{(plan.td, plan.th, plan.tw)} (query planes, rows, columns), groups of "
          f"{natten_flash.FWD_NQ} queries on {plan.lanes} lanes, chunks of {plan.nc} columns, "
          f"slab strip {plan.ry} x {plan.rx}, smem {plan.smem} B, {plan.ctas} CTAs an SM, "
          f"{plan.n_tiles} tiles | max_abs_err out/lse {err:.3e} | repeat bit-equal {repeats} | "
          f"kernel_ms={ms:.4f} (with lse {lse_ms:.4f}) plain_ms={plain_ms:.4f} sdpa_ms={sdpa_ms:.4f} "
          f"(SDPA on {tuple(bias.shape)} masked halo tiles {(tile.td, tile.th, tile.tw)})", flush=True)
    if not (err <= K5_TOL):
        raise AssertionError(f"K5a {name}: max abs error {err} > {K5_TOL}")
    if not repeats:
        raise AssertionError(f"K5a {name}: out or lse differ between two launches")
    n_pairs = q[..., 0, 0].numel() * heads * math.prod(kernel)
    nbytes = 4 * (4 * q[..., 0].numel() * q.shape[-1] + rpb.numel())  # q, k, v, out, rpb
    del qt, kt, vt, bias
    return dict(err=err, ms=ms, lse_ms=lse_ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                flops=4 * n_pairs * q.shape[-1], nbytes=nbytes)


def k5b_case(natten_flash, name, gen, kernel, heads, circular):
    """K5b (dq and dk/dv kernels, drpb from their partials) against the plain
    backward, on K5a's out and lse. Times the whole backward and, apart, the
    dq kernel (with its drpb partials), the dk/dv kernel, delta and the drpb
    sum. Returns a dict of errors, times (ms), flops and bytes."""
    q, k, v, rpb = natten_inputs(gen, kernel, heads)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = natten_flash._forward_cuda(q, k, v, kernel, rpb, circular, with_lse=True)
    args = (q, k, v, rpb, out, lse, dout, kernel, circular)
    got = natten_flash._backward_cuda(*args)
    torch.cuda.synchronize()
    want = natten_flash.natten_flash_backward_reference(*args)
    errs = {f"d{n}": (a - b).abs().max().item() for n, a, b in zip("qkv", got[:3], want[:3])}
    errs["drpb_rel"] = (got[3] - want[3]).abs().max().item() / want[3].abs().max().item()
    ms = cuda_ms(lambda: natten_flash._backward_cuda(*args))
    delta = (dout * out).sum(-1).contiguous()
    grads = tuple(torch.empty_like(q) for _ in range(3))
    tile = natten_flash._pick_tile("dq", WM_LATENT, kernel, circular, q.shape[-1], True)
    partial = torch.empty(tile.n_tiles, heads, rpb[0].numel(), device="cuda")

    def kernel_fn(mode):
        return lambda: natten_flash.launch_backward(
            mode, q, k, v, rpb, dout, lse, delta, grads, partial, kernel, circular)

    split = {"dq": cuda_ms(kernel_fn(natten_flash.DQ)), "dkv": cuda_ms(kernel_fn(natten_flash.DKV)),
             "delta": cuda_ms(lambda: (dout * out).sum(-1).contiguous()),
             "drpb_sum": cuda_ms(lambda: partial.sum(0).reshape(rpb.shape))}
    plain_ms = cuda_ms(lambda: natten_flash.natten_flash_backward_reference(*args), runs=3, batch=1)
    qt, kt, vt, bias, dot = natten_sdpa_inputs(natten_flash, q, k, v, kernel, rpb, circular, dout)
    qt, kt, vt = (t.requires_grad_(True) for t in (qt, kt, vt))
    o = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias)
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True))
    print(f"[k5b] {name}: kernel {kernel} heads {heads} x 32 circular_w={circular} | max_abs_err "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" | kernels_ms={ms:.4f} (dq + dk/dv + delta + drpb sum): dq {split['dq']:.4f} (with "
          f"drpb partials) dk/dv {split['dkv']:.4f} delta {split['delta']:.4f} drpb sum "
          f"{split['drpb_sum']:.4f} | plain_ms={plain_ms:.4f} sdpa_bwd_ms={sdpa_ms:.4f}", flush=True)
    for n, e in errs.items():
        if not (e <= K5_TOL):
            raise AssertionError(f"K5b {name}: {n} error {e} > {K5_TOL}")
    n_pairs = q[..., 0, 0].numel() * heads * math.prod(kernel)
    n = q[..., 0].numel() * q.shape[-1]
    nbytes = 4 * (8 * n + 2 * lse.numel() + 2 * rpb.numel())  # q k v out dO dq dk dv, lse, rpb drpb
    del qt, kt, vt, bias, dot, o
    # Apart: the dq kernel computes s, dp and dq (6 ch flops per pair) and
    # moves q, k, v, dO, dq, lse, delta and the drpb partials' rpb; the dk/dv
    # kernel s, dp, dk and dv (8 ch) and q, k, v, dO, dk, dv, lse, delta.
    stats = 4 * 2 * lse.numel()
    return dict(errs=errs, ms=ms, split=split, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                flops=10 * n_pairs * q.shape[-1], nbytes=nbytes,
                flops_split={"dq": 6 * n_pairs * q.shape[-1], "dkv": 8 * n_pairs * q.shape[-1]},
                nbytes_split={"dq": 4 * 5 * n + stats + 4 * 2 * rpb.numel(), "dkv": 4 * 6 * n + stats})


def window_chunks(window_indices, q, k, v, kernel, rpb, circular, chunk_bytes, dout=None):
    """Each query's gathered window (kd * kh * kw keys) in chunks of queries
    whose gathered K and V take `chunk_bytes`: yields (first query, q
    [n, heads, 1, ch], k and v [n, heads, slots, ch], rpb as an additive
    bias [n, heads, 1, slots] (zeros without rpb), and dO like q when
    given). Gathered on the card; the library yardstick of K6 and K6b."""
    _, d, h, w, heads, ch = q.shape
    dev = q.device
    tables = [
        tuple(torch.as_tensor(t, dtype=torch.long, device=dev) for t in window_indices(size, kk, circ))
        for size, kk, circ in zip((d, h, w), kernel, (False, False, circular))
    ]
    (id_, rd), (ih, rh), (iw, rw) = tables
    nrh, nrw = 2 * kernel[1] - 1, 2 * kernel[2] - 1

    def per_query(a, b, c):  # [size, k] per axis -> [D * H * W, kd * kh * kw]
        t = (a[:, None, None, :, None, None] + b[None, :, None, None, :, None]
             + c[None, None, :, None, None, :])
        return t.reshape(d * h * w, -1)

    key_ids = per_query(id_ * h * w, ih * w, iw)
    rel_ids = per_query(rd * nrh * nrw, rh * nrw, rw)
    qf, kf, vf = (t.reshape(d * h * w, heads, ch) for t in (q, k, v))
    bias_table = (rpb.reshape(heads, -1) if rpb is not None
                  else torch.zeros(heads, int(rel_ids.max()) + 1, device=dev))
    slots = key_ids.shape[1]
    chunk = max(1, chunk_bytes // (2 * 4 * slots * heads * ch))
    for s in range(0, d * h * w, chunk):
        ids = key_ids[s:s + chunk]
        kt, vt = (t[ids].transpose(1, 2).contiguous() for t in (kf, vf))
        bias = bias_table[:, rel_ids[s:s + chunk]].transpose(0, 1)[:, :, None, :].contiguous()
        extra = () if dout is None else (dout.reshape(d * h * w, heads, ch)[s:s + chunk, :, None, :],)
        yield (s, qf[s:s + chunk, :, None, :], kt, vt, bias, *extra)


def window_sdpa_ms(window_indices, ref, q, k, v, kernel, rpb, circular, chunk_bytes=2 * 2**30):
    """The library yardstick of K6: SDPA over each query's gathered window
    with rpb as an additive bias (window_chunks). Returns (the chunks' median
    ms summed, the max abs error of the first chunk's output against `ref`,
    the plain version's output). Timed only, never used by the port."""
    _, d, h, w, heads, ch = q.shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    total_ms, err = 0.0, None
    for s, qt, kt, vt, bias in window_chunks(window_indices, q, k, v, kernel, rpb, circular,
                                             chunk_bytes):
        if err is None:
            got = sdpa(qt, kt, vt, attn_mask=bias)[:, :, 0]
            err = (got - ref.reshape(d * h * w, heads, ch)[s:s + qt.shape[0]]).abs().max().item()
            del got
        total_ms += cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias), runs=3, batch=2)
        del qt, kt, vt, bias
    return total_ms, err


SDPA_BWD_RUNS = 2  # phase 41's timed runs of SDPA's backward per chunk (and of the plain backward)


def window_sdpa_bwd_ms(window_indices, q, k, v, dout, kernel, rpb, circular,
                       chunk_bytes=2 * 2**30):
    """The library yardstick of K6b: SDPA's backward (dq, and dk and dv of
    the gathered windows) over window_chunks, the forward outside the
    timing; the chunks' medians of SDPA_BWD_RUNS runs summed. Timed only."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    total_ms = 0.0
    for _, qt, kt, vt, bias, dot in window_chunks(window_indices, q, k, v, kernel, rpb, circular,
                                                  chunk_bytes, dout):
        qt, kt, vt = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
        o = sdpa(qt, kt, vt, attn_mask=bias)
        total_ms += cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
                            runs=SDPA_BWD_RUNS, batch=1)
        del qt, kt, vt, bias, dot, o
    return total_ms


def k6_case(natten3d, natten_flash, neighborhood_attention_3d, reference, window_indices, name,
            gen, kernel, heads, ch, circular, via_pallas=False):
    """K6 against its plain version on the 1-degree latent: directly, or (via
    `via_pallas`) through the dispatcher's impl="pallas" and also against
    K5a. Returns a dict of errors, times (ms), flops and bytes."""
    q, k, v, rpb = natten_inputs(gen, kernel, heads, ch)
    args = (q, k, v, kernel, rpb, circular)
    if via_pallas:
        out = neighborhood_attention_3d(*args, impl="pallas")
    else:
        out = natten3d.neighborhood_attention_3d_slot(*args)
    torch.cuda.synchronize()
    ref = reference(*args)
    err = (out - ref).abs().max().item()
    k5a_err = None
    if via_pallas:
        k5a_err = (out - natten_flash._forward_cuda(*args, with_lse=False)[0]).abs().max().item()
    library_ms, library_err = window_sdpa_ms(window_indices, ref, *args)
    del ref
    ms = cuda_ms(lambda: natten3d._forward_cuda(*args))
    plain_ms = cuda_ms(lambda: reference(*args), runs=3, batch=2)
    print(f"[k6] {name}: kernel {kernel} heads {heads} x {ch} circular_w={circular}"
          f"{' via impl=pallas' if via_pallas else ''} | max_abs_err {err:.3e}"
          + (f" (against K5a {k5a_err:.3e})" if via_pallas else "")
          + f" | kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (SDPA "
          f"on each query's {math.prod(kernel)}-key window, rpb as bias; its error against the "
          f"plain version {library_err:.3e})", flush=True)
    for what, e in (("plain version", err), ("K5a", k5a_err)):
        if e is not None and not (e <= K5_TOL):
            raise AssertionError(f"K6 {name}: max abs error against the {what} {e} > {K5_TOL}")
    n_pairs = q[..., 0, 0].numel() * heads * math.prod(kernel)
    nbytes = 4 * (4 * q[..., 0].numel() * ch + rpb.numel())  # q, k, v, out, rpb
    return dict(err=max(err, k5a_err or 0.0), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                flops=4 * n_pairs * ch, nbytes=nbytes, pairs=n_pairs)


def k6b_case(natten3d, natten_flash, reference, window_indices, name, gen, kernel, heads, ch,
             circular, bias=True):
    """K6 with lse against its plain version, and K6b (the dq and dk/dv
    kernels, delta, the drpb sum) against the plain backward on K6's out and
    lse, on the 1-degree latent; out, lse and the gradients repeated bit for
    bit. Times K6 with and without lse, each K6b kernel, the whole backward,
    the plain backward and SDPA's backward on the gathered windows. Returns
    a dict of errors, times (ms), flops and bytes."""
    q, k, v, rpb = natten_inputs(gen, kernel, heads, ch)
    rpb = rpb if bias else None
    args = (q, k, v, kernel, rpb, circular)
    out, lse = natten3d._forward_cuda(*args, with_lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = reference(*args, with_lse=True)
    fwd_err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
    del ref_out, ref_lse
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    bargs = (q, k, v, rpb, out, lse, dout, kernel, circular)
    got = natten3d._backward_cuda(*bargs)
    again = natten3d._backward_cuda(*bargs)
    out2, lse2 = natten3d._forward_cuda(*args, with_lse=True)
    torch.cuda.synchronize()
    repeats = (torch.equal(out, out2) and torch.equal(lse, lse2)
               and all(torch.equal(a, b) for a, b in zip(got, again) if a is not None))
    want = natten_flash.natten_flash_backward_reference(*bargs)
    errs = {n: ((a - b).abs().max() / b.abs().max()).item()
            for n, a, b in zip(("dq", "dk", "dv", "drpb"), got, want) if b is not None}
    del got, again, want, out2, lse2
    fwd_ms = cuda_ms(lambda: natten3d._forward_cuda(*args))
    lse_ms = cuda_ms(lambda: natten3d._forward_cuda(*args, with_lse=True))
    ms = cuda_ms(lambda: natten3d._backward_cuda(*bargs))
    grads = tuple(torch.empty_like(q) for _ in range(3))
    dq_plan, dkv_plan = natten3d.plan_backward(tuple(q.shape), kernel, circular, bias)
    partial = (torch.empty(dq_plan.n_tiles, heads, rpb[0].numel(), device="cuda") if bias
               else None)
    table = torch.empty(natten3d.table_shape(q.shape, kernel), device="cuda")

    def kernel_fn(mode):
        return lambda: natten3d.launch_backward(mode, q, k, v, rpb, dout, lse, out, grads,
                                                partial, table, kernel, circular)

    split = {"dq": cuda_ms(kernel_fn(natten3d.DQ)), "dkv": cuda_ms(kernel_fn(natten3d.DKV))}
    plain_ms = cuda_ms(lambda: natten_flash.natten_flash_backward_reference(*bargs),
                       runs=SDPA_BWD_RUNS, batch=1)
    library_ms = window_sdpa_bwd_ms(window_indices, q, k, v, dout, kernel, rpb, circular)
    print(f"[k6b] {name}: kernel {kernel} heads {heads} x {ch} circular_w={circular} rpb={bias} | "
          f"K6 out/lse max_abs_err {fwd_err:.3e} | K6b error / max|g| "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" | repeat bit-equal {repeats} | plans dq {dq_plan} dk/dv {dkv_plan} | K6 ms {fwd_ms:.4f}, "
          f"with lse {lse_ms:.4f} | backward_ms={ms:.4f} (dq with delta and the slot table's "
          f"writes {split['dq']:.4f} + dk/dv {split['dkv']:.4f} + drpb sum; table "
          f"{dq_plan.table / 1e6:.1f} MB) | plain_ms={plain_ms:.4f} "
          f"sdpa_bwd_ms={library_ms:.4f} (SDPA's backward on each query's "
          f"{math.prod(kernel)}-key window, rpb as bias; plain and SDPA medians of "
          f"{SDPA_BWD_RUNS} runs)", flush=True)
    if not (fwd_err <= K5_TOL):
        raise AssertionError(f"K6 {name}: out or lse error {fwd_err} > {K5_TOL}")
    for n, e in errs.items():
        if not (e <= K5_TOL):
            raise AssertionError(f"K6b {name}: {n} error {e} of its max|g| > {K5_TOL}")
    if not repeats:
        raise AssertionError(f"K6b {name}: out, lse or a gradient differs between two launches")
    n_pairs = q[..., 0, 0].numel() * heads * math.prod(kernel)
    n = q[..., 0].numel() * ch
    stats = 4 * lse.numel()
    rpb_bytes = 4 * rpb.numel() if bias else 0
    return dict(errs=errs, fwd_err=fwd_err, ms=ms, split=split, fwd_ms=fwd_ms, lse_ms=lse_ms,
                plain_ms=plain_ms, library_ms=library_ms, pairs=n_pairs, table=dq_plan.table,
                # q k v out dO dq dk dv, lse, rpb and drpb; the function's
                # s, dp, dq, dk and dv (10 ch flops per pair). Apart: the dq
                # kernel's s, dp and dq (6 ch) over q k v out dO dq, lse,
                # rpb, drpb and the slot table it writes; the dk/dv
                # kernel's dk and dv (4 ch) over q dO dk dv and the table it
                # reads
                flops=10 * n_pairs * ch, nbytes=4 * 8 * n + stats + 2 * rpb_bytes,
                flops_split={"dq": 6 * n_pairs * ch, "dkv": 4 * n_pairs * ch},
                nbytes_split={"dq": 4 * 6 * n + stats + 2 * rpb_bytes + dq_plan.table,
                              "dkv": 4 * 4 * n + dq_plan.table})


def band_sdpa_inputs(band_windows, q, k, v, masks, block, w, dout=None):
    """The library yardstick's inputs: each receiver block's queries
    [nb, h, block, c] against its stacked window of keys and values
    [nb, h, block + 2w, c], the band mask [nb, 1, block, block + 2w] as a
    boolean mask; `dout` (dO) is blocked like q. Built on the card, outside
    any timing."""
    nb = masks.shape[0]
    heads, c = q.shape[-2:]

    def blocks(t):
        t = torch.nn.functional.pad(t[0], (0, 0, 0, 0, 0, nb * block - t.shape[1]))
        return t.reshape(nb, block, heads, c).transpose(1, 2).contiguous()

    def windows(t):
        return band_windows(t[0], nb, block, w).transpose(1, 2).contiguous()

    out = [blocks(q), windows(k), windows(v), masks.bool()[:, None]]
    if dout is not None:
        out.append(blocks(dout))
    return out


def band_inputs(gen, khop, c, heads, count):
    """`count` tensors [1, nb * block, heads, c] ~N(0, 1) over the padded
    rows of the band layout, and contiguous copies of their first N rows
    (the processor's shapes)."""
    n_pad = khop.band_masks.shape[0] * khop.band_block
    padded = [torch.randn(1, n_pad, heads, c, generator=gen, device="cuda") for _ in range(count)]
    return padded, [t[:, :khop.n_receivers].contiguous() for t in padded]


def k4a_case(banded_flash, band_windows, khop, gen, c, heads=4):
    """K4a against its plain version on the real band layout at the
    processor's shapes ([1, N, heads, c]), with and without lse, and once
    over the padded rows (nb * block), whose rows past N must come out
    exactly 0. Returns a dict of errors, times (ms), flops and bytes."""
    masks, block, w, n = khop.band_masks, khop.band_block, khop.band_w, khop.n_receivers
    (qp, kp, vp), (q, k, v) = band_inputs(gen, khop, c, heads, 3)
    args = (q, k, v, masks, block, w)
    out = banded_flash._forward_cuda(*args, with_lse=False)[0]
    out_lse, lse = banded_flash._forward_cuda(*args, with_lse=True)
    padded, padded_lse = banded_flash._forward_cuda(qp, kp, vp, masks, block, w, with_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = banded_flash.banded_flash_forward_reference(*args, with_lse=True)
    err = max((a - b).abs().max().item() for a, b in (
        (out, ref), (out_lse, ref), (lse, ref_lse), (padded[:, :n], ref), (padded_lse[:, :n], ref_lse[:, :n])))
    zeros = bool((padded[:, n:] == 0).all()) and bool((padded_lse[:, n:] < -1e27).all())
    ms = cuda_ms(lambda: banded_flash._forward_cuda(*args, with_lse=False))
    lse_ms = cuda_ms(lambda: banded_flash._forward_cuda(*args, with_lse=True))
    plain_ms = cuda_ms(lambda: banded_flash.banded_flash_forward_reference(*args), runs=3, batch=2)
    q_b, k_w, v_w, attend = band_sdpa_inputs(band_windows, q, k, v, masks, block, w)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_ms = cuda_ms(lambda: sdpa(q_b, k_w, v_w, attn_mask=attend))
    print(f"[k4a] c={c}: nb={masks.shape[0]} block={block} w={w} heads={heads} | max_abs_err "
          f"out/lse {err:.3e} padded_rows_zero={zeros} | kernel_ms={ms:.4f} (with lse {lse_ms:.4f}) "
          f"plain_ms={plain_ms:.4f} sdpa_ms={sdpa_ms:.4f} (SDPA on {tuple(attend.shape)} masked "
          f"windows)", flush=True)
    if not (err <= K4_TOL):
        raise AssertionError(f"K4a c={c}: max abs error {err} > {K4_TOL}")
    if not zeros:
        raise AssertionError(f"K4a c={c}: padded rows are not exactly 0")
    del q_b, k_w, v_w, attend
    # The work these inputs need: q.k and p.v over the real edges; q, k, v,
    # out and the mask moved once.
    return dict(err=err, ms=ms, lse_ms=lse_ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                flops=4 * khop.senders.shape[0] * heads * c,
                nbytes=4 * 4 * q.numel() + masks.numel())


def k4b_case(banded_flash, band_windows, khop, gen, c, heads=4):
    """K4b against the plain backward on K4a's out and lse at the processor's
    shapes, its dk/dv kernel in the symmetric role (the k-hop graph is
    symmetric) and in the general role, and once over the padded rows,
    whose gradients past N must be exactly 0. Times both kernels in each
    role alone, the whole backward (delta and both kernels, symmetric), the
    plain backward and SDPA's backward. Returns a dict of errors, times
    (ms), flops and bytes."""
    masks, block, w, n = khop.band_masks, khop.band_block, khop.band_w, khop.n_receivers
    (qp, kp, vp, dop), (q, k, v, dout) = band_inputs(gen, khop, c, heads, 4)
    out, lse = banded_flash._forward_cuda(q, k, v, masks, block, w, with_lse=True)
    args = (q, k, v, masks, out, lse, dout, block, w)
    got = banded_flash._backward_cuda(*args, symmetric=True)
    general = banded_flash._backward_cuda(*args, symmetric=False)
    out_p, lse_p = banded_flash._forward_cuda(qp, kp, vp, masks, block, w, with_lse=True)
    padded = banded_flash._backward_cuda(qp, kp, vp, masks, out_p, lse_p, dop, block, w, symmetric=True)
    torch.cuda.synchronize()
    want = banded_flash.banded_flash_backward_reference(*args)
    errs = {f"d{nm}": (a - b).abs().max().item() for nm, a, b in zip("qkv", got, want)}
    errs["general"] = max((a - b).abs().max().item() for a, b in zip(general, want))
    errs["padded"] = max((a[:, :n] - b).abs().max().item() for a, b in zip(padded, want))
    zeros = all(bool((t[:, n:] == 0).all()) for t in padded)
    n_pad = masks.shape[0] * block
    delta = torch.nn.functional.pad((dout * out).sum(-1), (0, 0, 0, n_pad - n)).contiguous()
    grads = tuple(torch.empty_like(t) for t in (q, k, v))

    def kernel(mode, symmetric=True):
        return lambda: banded_flash.launch_backward(
            mode, q, k, v, masks, lse, dout, delta, grads, block, w, symmetric)

    ms = {"dq": cuda_ms(kernel(banded_flash.DQ)), "dkv": cuda_ms(kernel(banded_flash.DKV)),
          "dkv_general": cuda_ms(kernel(banded_flash.DKV, symmetric=False)),
          "all": cuda_ms(lambda: banded_flash._backward_cuda(*args, symmetric=True))}
    plain_ms = cuda_ms(lambda: banded_flash.banded_flash_backward_reference(*args), runs=3, batch=1)
    q_b, k_w, v_w, attend, do_b = band_sdpa_inputs(band_windows, q, k, v, masks, block, w, dout)
    q_b, k_w, v_w = (t.requires_grad_(True) for t in (q_b, k_w, v_w))
    o_b = torch.nn.functional.scaled_dot_product_attention(q_b, k_w, v_w, attn_mask=attend)
    sdpa_ms = cuda_ms(lambda: torch.autograd.grad(o_b, (q_b, k_w, v_w), do_b, retain_graph=True))
    print(f"[k4b] c={c}: max_abs_err " + " ".join(f"{nm} {e:.3e}" for nm, e in errs.items())
          + f" | padded_rows_zero_grads={zeros} | dq_ms={ms['dq']:.4f} dkv_ms={ms['dkv']:.4f} "
          f"(symmetric) dkv_general_ms={ms['dkv_general']:.4f} backward_ms={ms['all']:.4f} "
          f"(delta + both) plain_ms={plain_ms:.4f} sdpa_bwd_ms={sdpa_ms:.4f}", flush=True)
    for nm, e in errs.items():
        if not (e <= K4_TOL):
            raise AssertionError(f"K4b c={c}: {nm} error {e} > {K4_TOL}")
    if not zeros:
        raise AssertionError(f"K4b c={c}: padded rows have non-zero gradients")
    del q_b, k_w, v_w, attend, do_b, o_b
    # The work these inputs need over the real edges: s, dp and dq (dq
    # kernel); s, dp, dk and dv (dk/dv kernel); each moves its rows, lse,
    # delta and the mask once.
    edges, rows = khop.senders.shape[0], 4 * q.numel()
    stats = 4 * 2 * lse.numel() + masks.numel()
    return dict(errs=errs, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                flops={"dq": 6 * edges * heads * c, "dkv": 8 * edges * heads * c},
                nbytes={"dq": 5 * rows + stats, "dkv": 6 * rows + stats})


def k4b_directed_case(banded_flash, build_band_masks, gen, c, n=10242, w=1024, heads=4):
    """K4b's general role on a directed band of GenCast's size: each node
    receives from 6 random nodes within +-w, every 7th node receives from
    none; inputs over the padded rows. dq, dk, dv against the plain backward
    within 1e-4, exact zeros on the padded rows and on dq of the receivers
    without an edge. Returns the max error."""
    rng = np.random.default_rng(c)
    receivers = np.repeat(np.arange(n), 6)
    senders = np.clip(receivers + rng.integers(-w, w + 1, receivers.size), 0, n - 1)
    pairs = np.unique(np.stack([receivers, senders], 1), axis=0)
    pairs = pairs[pairs[:, 0] % 7 != 0]
    masks = torch.as_tensor(build_band_masks(pairs[:, 1], pairs[:, 0], n, 512, w).astype(np.int8),
                            device="cuda")
    n_pad = masks.shape[0] * 512
    q, k, v, dout = (torch.randn(1, n_pad, heads, c, generator=gen, device="cuda") for _ in range(4))
    out, lse = banded_flash._forward_cuda(q, k, v, masks, 512, w, with_lse=True)
    args = (q, k, v, masks, out, lse, dout, 512, w)
    got = banded_flash._backward_cuda(*args, symmetric=False)
    torch.cuda.synchronize()
    want = banded_flash.banded_flash_backward_reference(*args)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    no_edge = torch.arange(n_pad, device="cuda")
    no_edge = (no_edge % 7 == 0) | (no_edge >= n)
    zeros = all(bool((t[:, n:] == 0).all()) for t in got) and bool((got[0][:, no_edge] == 0).all())
    print(f"[k4b] directed band c={c}: {pairs.shape[0]} edges, nb {masks.shape[0]}, w {w} | general "
          f"role max_abs_err {err:.3e} | exact zeros {zeros}", flush=True)
    if not (err <= K4_TOL):
        raise AssertionError(f"K4b general role on a directed band, c={c}: error {err} > {K4_TOL}")
    if not zeros:
        raise AssertionError(f"K4b general role on a directed band, c={c}: rows not exactly 0")
    return err


def grads_close(card: dict, cpu: dict) -> tuple[float, str]:
    """Worst (error / limit) over the parameters, and its name: each
    gradient within GRAD_RTOL of its tensor's max|g| on the CPU, floored at
    1e-6 of the largest gradient (the k projection's bias has an exactly-zero
    gradient: a shift of every key's logit cancels in the softmax)."""
    floor = 1e-6 * max(g.abs().max().item() for g in cpu.values())
    worst, name = 0.0, ""
    for key, g in cpu.items():
        limit = max(GRAD_RTOL * g.abs().max().item(), floor)
        ratio = (card[key] - g).abs().max().item() / limit
        if ratio > worst:
            worst, name = ratio, key
    return worst, name


def grads_near_exact(card: dict, cpu: dict, exact: dict) -> tuple[float, str, list]:
    """Phase 35's rule at ill-conditioned weights: each gradient within
    grads_close's limit of the CPU's, or else no further from the float64
    gradient, in norm, than F32_NOISE_FACTOR times the CPU's float32 one is.
    Returns the worst (card error / F32_NOISE_FACTOR x f32 error) over the
    tensors outside the first limit, its name, and (name, error / first
    limit, card error / f32 error) for each of them."""
    floor = 1e-6 * max(g.abs().max().item() for g in cpu.values())
    worst, name, outside = 0.0, "", []
    for key, g in cpu.items():
        ratio = (card[key] - g).abs().max().item() / max(GRAD_RTOL * g.abs().max().item(), floor)
        if ratio <= 1.0:
            continue
        want = exact[key].double()
        noise = (g.double() - want).norm().item()
        relative = (card[key].double() - want).norm().item() / max(noise, 1e-300)
        outside.append((key, ratio, relative))
        if relative / F32_NOISE_FACTOR > worst:
            worst, name = relative / F32_NOISE_FACTOR, key
    return worst, name, outside


def card_repeat(module, loss_fn, value: float, grads: dict, required: bool = False) -> str:
    """loss_fn()'s forward and backward once more on the card: whether the
    loss and every parameter's gradient repeat bit for bit, and where they do
    not, how many differ and the largest difference in grads_close's units
    (error / limit against the first run). With `required` a difference
    raises (every sum on the path runs in a fixed order); else it is
    printed only."""
    module.zero_grad(set_to_none=True)
    again = loss_fn()
    again.backward()
    repeat = {k: t.grad.cpu() for k, t in module.named_parameters()}
    module.zero_grad(set_to_none=True)
    differ = [k for k in grads if not torch.equal(repeat[k], grads[k])]
    if again.item() == value and not differ:
        return "card repeat bit-equal True"
    worst, worst_name = grads_close(repeat, grads)
    text = (f"card repeat bit-equal False: loss {value!r} then {again.item()!r}, {len(differ)} of "
            f"{len(grads)} gradients differ ({', '.join(differ[:6])}), worst error / limit against "
            f"the first {worst:.3e} ({worst_name})")
    if required:
        raise AssertionError(text)
    return text


def shallow_weathermesh(port, cfg, module, device, layers=WM_WIDE_CHECK_LAYERS):
    """A WeatherMesh of cfg with `layers` processor layers on `device`,
    holding `module`'s weights (its first `layers` processor layers)."""
    handle = port.WeatherMesh(**{**cfg, "processor_num_layers": layers}, device=device)
    keys = handle.module.state_dict().keys()
    handle.module.load_state_dict({k: v.to(device) for k, v in module.state_dict().items() if k in keys})
    return handle


def shallow_denoiser(port, cfg, module, device, blocks=GENCAST_CHECK_BLOCKS):
    """A Denoiser of cfg with `blocks` processor blocks on `device`, holding
    `module`'s weights: its first blocks - 1 processor blocks, then its last
    (the heads-averaged one) as the last."""
    handle = port.Denoiser(**{**cfg, "num_blocks": blocks}, device=device)
    last = cfg["num_blocks"] - 1
    state = {}
    for key, value in module.state_dict().items():
        found = re.search(r"CondTransformerBlock_(\d+)\.", key)
        if found and int(found.group(1)) == last:
            key = key.replace(found.group(0), f"CondTransformerBlock_{blocks - 1}.")
        elif found and int(found.group(1)) >= blocks - 1:
            continue
        state[key] = value.to(device)
    handle.module.load_state_dict(state)
    return handle


def forecaster_to_float64(model) -> None:
    """A CPU forecaster handle's weights and edge features in float64 (the
    port's plain versions take it): the exact gradients of phase 35."""
    model.module.double()
    for graph in ("g2m", "latent", "m2g"):
        g = getattr(model, graph)
        setattr(model, graph, dataclasses.replace(g, edge_attr=g.edge_attr.double()))


def tf32_mma_report(build, name: str, required: bool = True, kind: str = "TF32") -> str:
    """The count of TF32 tensor-core instructions (HMMA ... TF32; with kind=
    "BF16", the bf16 ones) in the SASS of the library built from
    csrc/<name>.cu, by cuobjdump (the CUDA toolkit's, or the copy Triton
    carries); raises when it is 0 and `required` (the kernel's products run
    on the tensor cores)."""
    sass = library_sass(build, name)
    if sass is None:
        return f"{kind} HMMA in SASS not read (no cuobjdump)"
    count = len(re.findall(rf"HMMA\.\S*{kind}", sass))
    if count == 0 and required:
        raise AssertionError(f"{name}.cu: no {kind} tensor-core instruction in its SASS")
    return f"{kind} HMMA in SASS {count}"


@functools.lru_cache(maxsize=None)
def library_sass(build, name: str):
    """The SASS of the library built from csrc/<name>.cu, by cuobjdump (the
    CUDA toolkit's, or the copy Triton carries); None without one."""
    tools = [Path(build._nvcc()).with_name("cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton

        tools.append(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    except ImportError:
        pass
    tool = next((t for t in tools if t is not None and Path(t).is_file()), None)
    if tool is None:
        return None
    return subprocess.run([str(tool), "-sass", str(build._so_path(name))],
                          capture_output=True, text=True, check=True).stdout


def mma_by_function(build, name: str, mangled: str) -> list[tuple[str, str, int]]:
    """(template arguments, kind, count) of the tensor-core instructions
    (HMMA ... TF32 in an f32 instantiation, HMMA ... BF16 in a bf16 one) in
    each function of csrc/<name>.cu's SASS whose mangled name holds
    `mangled` (as "Li768E"); [] where the SASS was not read."""
    sass = library_sass(build, name)
    if sass is None:
        return []
    parts = re.split(r"Function : (\S+)", sass)
    found = []
    for function, body in zip(parts[1::2], parts[2::2]):
        if mangled not in function:
            continue
        kind = "BF16" if "bfloat16" in function else "TF32"
        found.append(("<" + ", ".join(re.findall(r"Li(\d+)E", function)) + ">", kind,
                      len(re.findall(rf"HMMA\.\S*{kind}", body))))
    return found


def ptxas_by_kernel(build, name: str) -> list[str]:
    """ptxas's registers and spills of each kernel in csrc/<name>.cu's build
    log, by its template arguments (<CP, CL, NC, MINB> for K5a), marked bf16
    for the bf16 instantiations and kernels."""
    log = build.build_log_path(name)
    if not log.exists():
        return ["(cached build, no log)"]
    report, current = {}, None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            kernel = next((name for m in re.finditer(r"\d+", mangled) for k in range(len(m.group()))
                           for name in [mangled[m.end():m.end() + int(m.group()[k:])]]
                           if name.endswith("_kernel")), None)  # a length-prefixed name
            current = ((kernel + " " if kernel else "")
                       + "<" + ", ".join(re.findall(r"Li(\d+)E", mangled)) + ">"
                       + (" bf16" if "bfloat16" in mangled or "bf16" in mangled else ""))
        elif current and ("registers" in line or "spill" in line):
            report.setdefault(current, []).append(line.split(":", 1)[-1].strip())
    return [f"{kernel}: " + ", ".join(lines) for kernel, lines in report.items()]


def timed(fn):
    """(fn(), host ms) around work that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profile_request(fn, what: str = "request", table: dict | None = None):
    """One more request (or train step) under torch.profiler: device time by
    kernel, and the device's busy share of its wall time. Returns the count
    of device kernels and copies (None when none was recorded); fills
    `table`, where given, with [device ms, launches] by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = timed(fn)
    by_name: dict[str, list] = {}
    for e in prof.events():
        # Device kernels and copies; not the user-annotation ranges (as
        # Optimizer.step) that the profiler also files under the device.
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
    if table is not None:
        table.update(by_name)
    if not by_name:
        print("[profile] no device events recorded: device time not measured", flush=True)
        return None
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"[profile] {what} wall_ms {wall_ms:.3f} | device busy_ms {busy_ms:.3f} "
          f"({100 * busy_ms / wall_ms:.1f}%) | {sum(n for _, n in by_name.values())} kernels | "
          + " | ".join(f"{name[:60]} {ms:.3f} ms x{n}" for name, (ms, n) in top), flush=True)
    return sum(n for _, n in by_name.values())


def natten_bf16_inputs(gen, kernel, heads, ch, dims=WM_LATENT):
    """bf16 q, k, v [1, D, H, W, heads, ch] as views of one fused bf16 qkv
    tensor (the bf16 model's layout), bf16 rpb ~N(0, 0.5^2)."""
    q, k, v, rpb = natten_inputs(gen, kernel, heads, ch, dims)
    qkv = torch.cat([t.reshape(*t.shape[:-2], -1) for t in (q, k, v)], -1).bfloat16()
    q, k, v = (t.reshape(*t.shape[:-1], heads, ch) for t in qkv.chunk(3, dim=-1))
    return q, k, v, rpb.bfloat16()


def natten_bf16_bytes(n: int, lse: int, rpb: int, backward: bool) -> float:
    """Bytes a bf16 attention call must move: q, k, v, out (and dO, dq, dk,
    dv, with lse and delta in f32, and drpb) at 2 bytes, rpb."""
    return 2 * (8 if backward else 4) * n + (8 * lse if backward else 0) + 2 * (2 if backward else 1) * rpb


def k5_bf16_case(natten_flash, name, gen, kernel, heads, circular, ch=32):
    """K5a and K5b in bf16 against their plain versions (the TPU kernels'
    roundings) on WeatherMesh's 1-degree latent: out, dq, dk, dv and drpb
    within BF16_TOL of their max, lse within K5_TOL, all bit-equal over two
    launches. Times each bf16 kernel, the f32 kernel on the same values, the
    plain versions and SDPA in bf16 on the halo tiles. Returns a dict."""
    q, k, v, rpb = natten_bf16_inputs(gen, kernel, heads, ch)
    args = (q, k, v, kernel, rpb, circular)
    out, lse = natten_flash._forward_cuda(*args, with_lse=True)
    again = natten_flash._forward_cuda(*args, with_lse=True)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    bargs = (q, k, v, rpb, out, lse, dout, kernel, circular)
    got = natten_flash._backward_cuda(*bargs)
    got2 = natten_flash._backward_cuda(*bargs)
    torch.cuda.synchronize()
    repeats = (torch.equal(out, again[0]) and torch.equal(lse, again[1])
               and all(torch.equal(a, b) for a, b in zip(got, got2)))
    ref, ref_lse = natten_flash.flash_forward_reference(*args, with_lse=True)
    want = natten_flash.natten_flash_backward_reference(*bargs)
    errs = {"out": bf16_err(out, ref), **{n: bf16_err(a, b) for n, a, b in
                                           zip(("dq", "dk", "dv", "drpb"), got, want)}}
    lse_err = (lse - ref_lse).abs().max().item()
    del ref, ref_lse, want, got2, again
    f32 = tuple(t.float() for t in (q, k, v, rpb))
    f32_args = (*f32[:3], kernel, f32[3], circular)
    out32, lse32 = natten_flash._forward_cuda(*f32_args, with_lse=True)
    ms = {
        "k5a": cuda_ms(lambda: natten_flash._forward_cuda(*args, with_lse=False)),
        "k5a_f32": cuda_ms(lambda: natten_flash._forward_cuda(*f32_args, with_lse=False)),
        "k5a_plain": cuda_ms(lambda: natten_flash.flash_forward_reference(*args), runs=3, batch=1),
        "k5b": cuda_ms(lambda: natten_flash._backward_cuda(*bargs)),
        "k5b_f32": cuda_ms(lambda: natten_flash._backward_cuda(*f32[:3], f32[3], out32, lse32,
                                                              dout.float(), kernel, circular)),
        "k5b_plain": cuda_ms(lambda: natten_flash.natten_flash_backward_reference(*bargs), runs=2,
                             batch=1),
    }
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    grads = tuple(torch.empty_like(q) for _ in range(3))
    tile = natten_flash._pick_tile("dq", WM_LATENT, kernel, circular, ch, True)
    partial = torch.empty(tile.n_tiles, heads, rpb[0].numel(), device="cuda")
    for mode, key in ((natten_flash.DQ, "dq"), (natten_flash.DKV, "dkv")):
        ms[key] = cuda_ms(lambda mode=mode: natten_flash.launch_backward(
            mode, q, k, v, rpb, dout, lse, delta, grads, partial, kernel, circular))
    qt, kt, vt, bias, dot = (t.bfloat16() for t in natten_sdpa_inputs(
        natten_flash, *(t.float() for t in (q, k, v)), kernel, rpb.float(), circular, dout.float()))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms["sdpa"] = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=bias))
    qt, kt, vt = (t.requires_grad_(True) for t in (qt, kt, vt))
    o = sdpa(qt, kt, vt, attn_mask=bias)
    ms["sdpa_bwd"] = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True))
    del qt, kt, vt, bias, dot, o, out32, lse32
    n_pairs = q[..., 0, 0].numel() * heads * math.prod(kernel)
    n = q[..., 0].numel() * ch
    tpu = natten_flash.tpu_backward_tile(WM_LATENT, kernel, circular, heads, ch, True)
    print(f"[k5_bf16] {name}: kernel {kernel} heads {heads} x {ch} circular_w={circular} | error / "
          f"(2^-6 max) " + " ".join(f"{k_} {e[1]:.3f}" for k_, e in errs.items())
          + f" | lse max_abs_err {lse_err:.3e} | repeat bit-equal {repeats} | TPU backward tile {tpu} "
          f"| K5a bf16 {ms['k5a']:.4f} ms (f32 kernel on the same values {ms['k5a_f32']:.4f}, plain "
          f"{ms['k5a_plain']:.4f}, SDPA bf16 {ms['sdpa']:.4f}) | K5b bf16 {ms['k5b']:.4f} ms (dq "
          f"{ms['dq']:.4f} + dk/dv {ms['dkv']:.4f}; f32 kernels {ms['k5b_f32']:.4f}, plain "
          f"{ms['k5b_plain']:.4f}, SDPA bf16 backward {ms['sdpa_bwd']:.4f})", flush=True)
    if not all(e[1] <= 1.0 for e in errs.values()) or not (lse_err <= K5_TOL):
        raise AssertionError(f"K5a/K5b bf16 {name}: {errs}, lse {lse_err}")
    if not repeats:
        raise AssertionError(f"K5a/K5b bf16 {name}: a result differs between two launches")
    return dict(errs=errs, ms=ms, pairs=n_pairs,
                fwd=(4 * n_pairs * ch, natten_bf16_bytes(n, lse.numel(), rpb.numel(), False)),
                bwd=(10 * n_pairs * ch, natten_bf16_bytes(n, lse.numel(), rpb.numel(), True)),
                dq=(6 * n_pairs * ch, 2 * 5 * n + 8 * lse.numel() + 4 * rpb.numel()),
                dkv=(8 * n_pairs * ch, 2 * 6 * n + 8 * lse.numel() + 2 * rpb.numel()))


def k6_bf16_case(natten3d, window_indices, name, gen, kernel, heads, ch, circular):
    """K6 and K6b in bf16 against their plain versions (the slot scan's bf16
    roundings, as XLA computes them) on the 1-degree latent: out, dq, dk, dv
    and drpb within BF16_TOL of their max, lse and out32 within K5_TOL, all
    bit-equal over two launches. Times each bf16 kernel (K6b's dq, dk/dv and
    two drpb kernels apart), the f32 kernels on the same values, the plain
    versions and SDPA in bf16 on each query's gathered window. Returns a
    dict."""
    q, k, v, rpb = natten_bf16_inputs(gen, kernel, heads, ch)
    args = (q, k, v, kernel, rpb, circular)
    out32 = torch.empty(q.shape, device="cuda")
    out, lse = natten3d._forward_cuda(*args, with_lse=True, out32=out32)
    again = natten3d._forward_cuda(*args, with_lse=True)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    bargs = (q, k, v, rpb, out32, lse, dout, kernel, circular)
    got = natten3d._backward_cuda(*bargs)
    got2 = natten3d._backward_cuda(*bargs)
    torch.cuda.synchronize()
    repeats = (torch.equal(out, again[0]) and torch.equal(lse, again[1])
               and all(torch.equal(a, b) for a, b in zip(got, got2)))
    ref, ref_lse, ref32 = natten3d.slot_forward(*args)
    t0 = time.perf_counter()
    want = natten3d.slot_backward_reference(*bargs)
    torch.cuda.synchronize()
    plain_bwd_ms = (time.perf_counter() - t0) * 1e3  # once: ~250 slots of ordered scatters
    errs = {"out": bf16_err(out, ref), **{n: bf16_err(a, b) for n, a, b in
                                           zip(("dq", "dk", "dv", "drpb"), got, want)}}
    f32_errs = max((lse - ref_lse).abs().max().item(), (out32 - ref32).abs().max().item())
    del ref, ref_lse, ref32, want, got2, again
    f32 = tuple(t.float() for t in (q, k, v, rpb))
    f32_args = (*f32[:3], kernel, f32[3], circular)
    f32_out, f32_lse = natten3d._forward_cuda(*f32_args, with_lse=True)
    ms = {
        "k6": cuda_ms(lambda: natten3d._forward_cuda(*args)),
        "k6_f32": cuda_ms(lambda: natten3d._forward_cuda(*f32_args)),
        "k6_plain": cuda_ms(lambda: natten3d.slot_forward(*args), runs=2, batch=1),
        "k6b": cuda_ms(lambda: natten3d._backward_cuda(*bargs), runs=5, batch=2),
        "k6b_f32": cuda_ms(lambda: natten3d._backward_cuda(*f32[:3], f32[3], f32_out, f32_lse,
                                                          dout.float(), kernel, circular),
                           runs=5, batch=2),
        "k6b_plain": plain_bwd_ms,
    }
    del f32_out, f32_lse
    grads = tuple(torch.empty_like(q) for _ in range(3))
    table = torch.empty(natten3d.table_shape(q.shape, kernel), device="cuda")
    work = torch.empty(natten3d.work_floats(q.shape, kernel), device="cuda")
    drpb = torch.empty_like(rpb)
    for mode, key in ((natten3d.DQ, "dq"), (natten3d.DKV, "dkv"), (natten3d.DRPB_SLOTS, "drpb_slots"),
                      (natten3d.DRPB, "drpb")):
        ms[key] = cuda_ms(lambda mode=mode: natten3d.launch_backward_bf16(
            mode, q, k, v, rpb, dout, lse, out32, grads, table, work, drpb, kernel, circular),
            runs=5, batch=2)
    del grads, table, work
    ms["sdpa"], _ = window_sdpa_ms(window_indices, out, *args)
    ms["sdpa_bwd"] = window_sdpa_bwd_ms(window_indices, q, k, v, dout, kernel, rpb, circular)
    n_pairs = q[..., 0, 0].numel() * heads * math.prod(kernel)
    n = q[..., 0].numel() * ch
    print(f"[k6_bf16] {name}: kernel {kernel} heads {heads} x {ch} circular_w={circular} | error / "
          f"(2^-6 max) " + " ".join(f"{k_} {e[1]:.3f}" for k_, e in errs.items())
          + f" | lse, out32 max_abs_err {f32_errs:.3e} | repeat bit-equal {repeats} | K6 bf16 "
          f"{ms['k6']:.4f} ms (f32 kernel on the same values {ms['k6_f32']:.4f}, plain "
          f"{ms['k6_plain']:.4f}, SDPA bf16 {ms['sdpa']:.4f}) | K6b bf16 {ms['k6b']:.4f} ms (dq "
          f"{ms['dq']:.4f} + dk/dv {ms['dkv']:.4f} + drpb {ms['drpb_slots']:.4f} + "
          f"{ms['drpb']:.4f}; f32 kernels {ms['k6b_f32']:.4f}, plain once {ms['k6b_plain']:.1f}, "
          f"SDPA bf16 backward {ms['sdpa_bwd']:.4f})", flush=True)
    if not all(e[1] <= 1.0 for e in errs.values()) or not (f32_errs <= K5_TOL):
        raise AssertionError(f"K6/K6b bf16 {name}: {errs}, lse/out32 {f32_errs}")
    if not repeats:
        raise AssertionError(f"K6/K6b bf16 {name}: a result differs between two launches")
    return dict(errs=errs, ms=ms, pairs=n_pairs,
                fwd=(4 * n_pairs * ch, natten_bf16_bytes(n, lse.numel(), rpb.numel(), False)),
                bwd=(10 * n_pairs * ch, natten_bf16_bytes(n, lse.numel(), rpb.numel(), True) + 2 * n),
                dq=(6 * n_pairs * ch, 2 * 5 * n + 4 * n + 4 * lse.numel() + 2 * rpb.numel()),
                dkv=(4 * n_pairs * ch, 2 * 4 * n))


def wm_counts(natten_flash, natten3d):
    """Every NATTEN launch count: f32 K5a, dq, dk/dv; bf16 K5a, dq, dk/dv; f32
    K6, dq, dk/dv; bf16 K6, dq, dk/dv, drpb slots, drpb."""
    return (natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES,
            natten_flash.BF16_LAUNCHES, natten_flash.BF16_BWD_DQ_LAUNCHES,
            natten_flash.BF16_BWD_DKV_LAUNCHES, natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES,
            natten3d.BWD_DKV_LAUNCHES, natten3d.BF16_LAUNCHES, natten3d.BF16_BWD_DQ_LAUNCHES,
            natten3d.BF16_BWD_DKV_LAUNCHES, natten3d.BF16_DRPB_SLOT_LAUNCHES,
            natten3d.BF16_DRPB_LAUNCHES)


def zero_wm_counts(natten_flash, natten3d):
    for mod, names in ((natten_flash, ("LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES",
                                       "BF16_LAUNCHES", "BF16_BWD_DQ_LAUNCHES",
                                       "BF16_BWD_DKV_LAUNCHES")),
                       (natten3d, ("LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES", "BF16_LAUNCHES",
                                   "BF16_BWD_DQ_LAUNCHES", "BF16_BWD_DKV_LAUNCHES",
                                   "BF16_DRPB_SLOT_LAUNCHES", "BF16_DRPB_LAUNCHES"))):
        for n in names:
            setattr(mod, n, 0)


def wm_bf16_model_phases(port, natten_flash, natten3d, cfg, name, per_forward, counts_of, per_step,
                         check_grid, ref):
    """Phases 52-53 (cfg WEATHERMESH) or 54-55 (WM_WIDE): 3 bf16 requests
    with `per_forward` bf16 attention forwards each (counts_of(made) picks
    them), a profile and a 4-step rollout; 3 bf16 train steps of phase 23's
    objective and optimiser, a profile; then at the weights after the steps
    the bf16 gradients on the card (twice: whether they repeat, printed)
    and on the CPU at `check_grid`: RMSE of card bf16 - CPU bf16 in global
    norm within the larger of BF16_WM_RULE and the CPU's own one-ulp reading
    of the card's bf16-to-f32 distance (that reading, a second CPU run, is
    taken only where the card misses BF16_WM_RULE). `ref` holds the f32 phases' request
    and step times; `per_step` the launches a train step must make
    (wm_counts' order). Returns the launch counts of the requests and steps."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    wm = port.WeatherMesh(**cfg, device="cuda")
    wm.init(torch.Generator().manual_seed(0))
    with torch.no_grad():  # as phase 19
        for n, t in wm.module.named_parameters():
            if n.endswith(("qkv.bias", "proj.bias")):
                t.zero_()
    h, w = WM_GRID
    levels = cfg["pressure_levels"]
    wm_gen = torch.Generator().manual_seed(1)  # phase 19's requests and phase 23's targets
    surfaces = torch.randn(3, 1, h, w, 8, generator=wm_gen).to("cuda")
    pressures = torch.randn(3, 1, levels, h, w, 4, generator=wm_gen).to("cuda")
    bf16 = torch.bfloat16
    zero_wm_counts(natten_flash, natten3d)
    serve_ms = []
    for surface, pressure in zip(surfaces, pressures):
        before = wm_counts(natten_flash, natten3d)
        pred, ms = timed(lambda: wm.apply(surface, pressure, compute_dtype=bf16))
        made = tuple(a - b for a, b in zip(wm_counts(natten_flash, natten3d), before))
        if counts_of(made) != (per_forward,) or sum(made) != per_forward:
            raise AssertionError(f"a bf16 {name} request made {made} launches, expected {per_forward} "
                                 "bf16 attention forwards and nothing else")
        if (pred.surface.dtype != bf16 or pred.pressure.shape != (1, levels, h, w, 4)
                or not (torch.isfinite(pred.surface.float()).all()
                        and torch.isfinite(pred.pressure.float()).all())):
            raise AssertionError(f"bad bf16 {name} output: {pred.surface.dtype}, "
                                 f"{tuple(pred.pressure.shape)}")
        serve_ms.append(ms)
    serve_launches = wm_counts(natten_flash, natten3d)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{name}_serve_bf16] request_ms {[round(t, 3) for t in serve_ms]} | f32 "
          f"{[round(t, 3) for t in ref['request_ms']]} | bf16 attention launches per request "
          f"{per_forward}, f32 0 | peak GiB {serve_peak:.2f}", flush=True)
    kernels16 = profile_request(lambda: wm.apply(surface, pressure, compute_dtype=bf16),
                                f"bf16 {name} request")
    before = wm_counts(natten_flash, natten3d)
    roll, ms = timed(lambda: wm.apply(surface, pressure, forecast_steps=4, compute_dtype=bf16))
    made = sum(a - b for a, b in zip(wm_counts(natten_flash, natten3d), before))
    want = cfg["encoder_num_transformer_layers"] + 4 * cfg["processor_num_layers"] + cfg[
        "decoder_num_transformer_layers"]
    if made != want or not (torch.isfinite(roll.surface.float()).all()
                            and torch.isfinite(roll.pressure.float()).all()):
        raise AssertionError(f"the bf16 {name} rollout made {made} launches (expected {want}) or is "
                             "not finite")
    print(f"[{name}_serve_bf16] 4-step rollout finite | ms per step {ms / 4:.3f} | bf16 attention "
          f"launches {made} | kernels per request {kernels16} | phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    del roll, pred

    t0 = time.perf_counter()
    targets = tuple(torch.randn(t.shape, generator=wm_gen).to("cuda") for t in (surface, pressure))

    def objective(pred, tgt):
        return (((pred.surface.float() - tgt[0]) ** 2).mean()
                + ((pred.pressure.float() - tgt[1]) ** 2).mean())

    before_params = [t.detach().clone() for t in wm.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    zero_wm_counts(natten_flash, natten3d)
    step = port.make_train_step(wm.module.parameters(), wm.forward_fn(compute_dtype=bf16), objective,
                                port.make_optimizer(1e-4))
    step_ms, losses = [], []
    for _ in range(3):
        before = wm_counts(natten_flash, natten3d)
        loss, ms = timed(lambda: step(surface, pressure, targets))
        made = tuple(a - b for a, b in zip(wm_counts(natten_flash, natten3d), before))
        if made != per_step or not torch.isfinite(loss):
            raise AssertionError(f"a bf16 {name} train step made {made} launches (expected "
                                 f"{per_step}, wm_counts' order), loss {loss.item()}")
        step_ms.append(ms)
        losses.append(loss.item())
    train_launches = wm_counts(natten_flash, natten3d)
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = list(wm.module.parameters())
    moments = [t for st in step.optimizer.state.values() for t in st.values()
               if torch.is_tensor(t) and t.dim() > 0]
    if any(t.dtype != torch.float32 for t in params + moments):
        raise AssertionError(f"a {name} parameter or moment left f32 under the bf16 policy")
    unchanged = [n for (n, _), a, b in zip(wm.module.named_parameters(), before_params, params)
                 if torch.equal(a, b)]
    if unchanged:
        raise AssertionError(f"{name} parameters unchanged after 3 bf16 steps: {unchanged}")
    step_kernels = profile_request(lambda: step(surface, pressure, targets), f"bf16 {name} train step")
    print(f"[{name}_train_bf16] 3 steps | step_ms {[round(t, 3) for t in step_ms]} | steady median "
          f"{statistics.median(step_ms[1:]):.3f} (f32: {ref['train_ms']:.3f}) | loss "
          f"{[round(v, 6) for v in losses]} | launches per step {per_step} (wm_counts' order) | all "
          f"{len(params)} f32 parameter tensors changed, f32 moments | peak GiB {peak:.2f} | kernels "
          f"per step {step_kernels} | phase {time.perf_counter() - t0:.1f} s", flush=True)
    del step, before_params, moments, surfaces, pressures

    t0 = time.perf_counter()
    ch_, cw_ = check_grid
    check = [torch.randn(1, ch_, cw_, 8, generator=wm_gen),
             torch.randn(1, levels, ch_, cw_, 4, generator=wm_gen)]
    check_targets = tuple(torch.randn(t.shape, generator=wm_gen) for t in check)

    def grads(handle, dtype, inputs, tgts, device):
        handle.module.zero_grad(set_to_none=True)
        value = objective(handle.forward_fn(compute_dtype=dtype)(*(t.to(device) for t in inputs)),
                          tuple(t.to(device) for t in tgts))
        value.backward()
        return value.item(), {k: t.grad.cpu() for k, t in handle.module.named_parameters()}

    card_value, card16 = grads(wm, bf16, check, check_targets, "cuda")
    again_value, again = grads(wm, bf16, check, check_targets, "cuda")
    differ = [k for k in card16 if not torch.equal(card16[k], again[k])]
    repeat = (f"card repeat bit-equal {card_value == again_value and not differ}"
              + (f" ({len(differ)} of {len(card16)} gradients differ)" if differ else ""))
    del again
    depth = ""
    layers = cfg["processor_num_layers"]
    if cfg is WM_WIDE:  # card against CPU at WM_WIDE_CHECK_LAYERS processor layers
        layers = WM_WIDE_CHECK_LAYERS
        wm = shallow_weathermesh(port, cfg, wm.module, "cuda", layers)
        card_value, card16 = grads(wm, bf16, check, check_targets, "cuda")
        depth = f", {layers} processor layers"
    _, card32 = grads(wm, torch.float32, check, check_targets, "cuda")
    cpu = shallow_weathermesh(port, cfg, wm.module, "cpu", layers)
    t1 = time.perf_counter()
    cpu_value, cpu16 = grads(cpu, bf16, check, check_targets, "cpu")
    cpu_s = time.perf_counter() - t1
    to_cpu = global_norm({k: card16[k] - cpu16[k] for k in card16})
    to_f32 = global_norm({k: card16[k] - card32[k] for k in card16})
    own = None  # the CPU's own reading, a second CPU run, only where the rule alone is missed
    if not (to_cpu <= BF16_WM_RULE * to_f32):
        flipped = [one_ulp_off(t, 12 + i)[0] for i, t in enumerate(check)]
        cpu_flipped = grads(cpu, bf16, flipped, check_targets, "cpu")[1]
        own = global_norm({k: cpu16[k] - cpu_flipped[k] for k in card16}) / to_f32
        del cpu_flipped
    limit = max(BF16_WM_RULE, own or 0.0)
    own_text = ("not needed" if own is None
                else f"with its inputs one ulp off at {BF16_FLIP_SHARE} {own:.3f}")
    print(f"[cpu] bf16 {name} gradients at {ch_} x {cw_}{depth} after the steps: global norm card bf16 - "
          f"CPU bf16 {to_cpu:.4e} | card bf16 - card f32 {to_f32:.4e} | ratio {to_cpu / to_f32:.3f} "
          f"(limit {limit:.3f}: the larger of {BF16_WM_RULE} and the CPU's own reading) | CPU bf16 "
          f"against itself {own_text} | loss card {card_value:.6f} cpu {cpu_value:.6f} | {repeat} | "
          f"cpu bf16 forward+backward {cpu_s:.2f} s | phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    if not (to_cpu <= limit * to_f32):
        raise AssertionError(f"bf16 {name} gradients card vs CPU: {to_cpu} > {limit} x {to_f32}")
    del cpu, wm, card16, card32, cpu16
    torch.cuda.empty_cache()
    return dict(serve_launches=serve_launches, train_launches=train_launches,
                serve_ms=serve_ms, step_ms=statistics.median(step_ms[1:]), per_step=per_step)


def weathermesh_bf16_phases(port, natten_flash, natten3d, window_indices, build, gen, ref) -> dict:
    """Phases 51-55: WeatherMesh's bf16 policy on the card (see the module
    docstring). `ref` holds phases 19, 23, 38 and 42's request and step
    times. Returns what the kernels' JSON line reads."""
    # 51. K5a, K5b, K6 and K6b in bf16 (built in phase 2)
    t0 = time.perf_counter()
    regs = [f"{lib}: " + " | ".join(r for r in ptxas_by_kernel(build, lib) if "bf16" in r)
            for lib in ("natten_flash", "natten_flash_bwd", "natten3d", "natten3d_bwd")]
    print("[build] the bf16 NATTEN kernels (phase 2's build) | " + " || ".join(regs), flush=True)
    k5 = k5_bf16_case(natten_flash, "a", gen, (3, 5, 5), 4, False)
    k6 = {n: k6_bf16_case(natten3d, window_indices, n, gen, (5, 7, 7), 8, 96, circ)
          for n, circ in (("a", False), ("b", True))}
    out = {"k5": k5, "k6": k6["a"], "k6_errs": {n: max(e[1] for e in c["errs"].values())
                                                for n, c in k6.items()}}
    for key, case in (("k5a", k5), ("k6", k6["a"])):
        out[key + "_bound"] = bf16_bound(*case["fwd"])
    for key, case in (("k5b", k5), ("k6b", k6["a"])):
        out[key + "_bound"] = bf16_bound(*case["bwd"])
        out[key + "_dq_bound"] = bf16_bound(*case["dq"])
        out[key + "_dkv_bound"] = bf16_bound(*case["dkv"])
    print(f"[natten_bf16] per request / train step: K5a bf16 {K5_PER_FORWARD * k5['ms']['k5a']:.4f} ms "
          f"(bound {K5_PER_FORWARD * out['k5a_bound'][0]:.4f}, {out['k5a_bound'][1]}), K5b bf16 "
          f"{K5_PER_FORWARD * k5['ms']['k5b']:.4f} (bound {K5_PER_FORWARD * out['k5b_bound'][0]:.4f}) | "
          f"K6 bf16 {K6_PER_FORWARD * k6['a']['ms']['k6']:.4f} (bound "
          f"{K6_PER_FORWARD * out['k6_bound'][0]:.4f}, {out['k6_bound'][1]}), K6b bf16 "
          f"{K6_PER_FORWARD * k6['a']['ms']['k6b']:.4f} (bound {K6_PER_FORWARD * out['k6b_bound'][0]:.4f}) "
          f"| phase {time.perf_counter() - t0:.1f} s", flush=True)
    # 52-53. the 128-d WeatherMesh in bf16; 54-55. the 768-d one
    out["wm"] = wm_bf16_model_phases(
        port, natten_flash, natten3d, WEATHERMESH, "wm", K5_PER_FORWARD, lambda m: (m[3],),
        (0,) * 3 + (K5_PER_FORWARD,) * 3 + (0,) * 8, WM_CHECK_GRID,
        dict(request_ms=ref["wm_ms"], train_ms=ref["wm_train_ms"]))
    out["wide"] = wm_bf16_model_phases(
        port, natten_flash, natten3d, WM_WIDE, "wm_wide", K6_PER_FORWARD, lambda m: (m[9],),
        (0,) * 9 + (K6_PER_FORWARD,) * 5, WM_WIDE_GRAD_GRID,
        dict(request_ms=ref["wide_ms"], train_ms=ref["wide_train_ms"]))
    return out


# FGN at bench.py's reference scale (metric_fgn, metric_fgn_ensemble): 128 x 64
# grid, 89 -> 83 features, a noise vector of 32, 768-d, 24 blocks of 4 heads
# (c = 192, the last c = 768), splits 6 and 6 hops, clustered attention.
FGN = dict(
    grid_lon=np.arange(0.0, 360.0, 360.0 / 128), grid_lat=np.linspace(-90.0, 90.0, 64),
    input_features_dim=89, output_features_dim=83, noise_dimension=32, hidden_dims=(768, 768),
    num_blocks=24, num_heads=4, splits=6, num_hops=6, use_edges_features=False,
    attention_impl="clustered_flash",
)
FGN_WIDTHS = {192: FGN["num_blocks"] - 1, 768: 1}  # K3a launches per member forward, by head width
FGN_MEMBERS = 8  # bench.py's fgn_ensemble: 8 members, member_chunk=1
FGN_CHECK_BLOCKS = 2  # phase 61's card-against-CPU depth: one block at c = 192, the last at 768
# Phase 61 holds FGN's bf16 card against the CPU within GenCast's limits
# (BF16_CARD_RULE, BF16_CARD_GRAD_RULE: FGN's blocks are GenCast's, as chaotic
# in bf16 at full width), and prints the card's own one-ulp reading beside
# it; beside a miss it takes the CPU's own reading, and the limit becomes
# the larger of that, 0.5 and GenCast's. At 2 blocks of 768-d, on four seeds
# of weights and inputs (scripts/fgn_bf16_chaos.py and this phase), the card
# read 0.605-0.611 (output) and 0.747-0.753 (gradients) from the CPU, and
# one ulp on 1 in 2,000 inputs moved the CPU's own run 0.586-0.589 and
# 0.722-0.734, the card's 0.580-0.591 and 0.722-0.735 (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md §6, PR 18).
# S's launches per FGN member forward (the g2m aggregation) and per train
# step (that, and the gradients of the encoder's and decoder's gathers onto
# edges: two each), in the member's dtype.
FGN_S_PER_FORWARD, FGN_S_PER_STEP = 1, 5


def sdpa_backend(q, k, v, mask) -> str:
    """The backend scaled_dot_product_attention takes for these inputs: the
    first, in its order of priority, that runs them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
    if hasattr(torch._C, "_get_sdp_priority_order"):
        order = [SDPBackend(i) for i in torch._C._get_sdp_priority_order()]
    for backend in order:
        try:
            with sdpa_kernel([backend]):
                torch.nn.functional.scaled_dot_product_attention(q[:1], k[:1], v[:1], attn_mask=mask[:1])
            return backend.name
        except RuntimeError:
            continue
    return "none"


def k3_fgn_case(clustered_flash, khop, gen, c, dtype, heads=4):
    """K3a (with and without lse) and K3c at head width c on FGN's splits-6
    layout, B = 1, in f32 or bf16: against the plain versions (f32 within
    K3A_TOL and K3_BWD_TOL; bf16 within BF16_TOL of the max, lse K3A_TOL),
    exact zeros on empty rows, a bit-equal repeat of out, lse, dq, dk and dv;
    CUDA-event medians of each, of the plain versions and of SDPA (and its
    backward) on the gathered unions with the adjacency as a boolean mask
    (timed only), the backend SDPA took, CTAs an SM. Returns a dict."""
    ids, masks, block = khop.cluster_ids, khop.cluster_masks, khop.cluster_block
    nb, u_pad = ids.shape
    n_pad = nb * block
    bf16 = dtype == torch.bfloat16
    q, k, v, dout = (torch.randn(1, n_pad, heads, c, generator=gen, device="cuda").to(dtype)
                     for _ in range(4))
    fwd = clustered_flash._forward_cuda
    out = fwd(q, k, v, ids, masks, block, with_lse=False)[0]
    out_l, lse = fwd(q, k, v, ids, masks, block, with_lse=True)
    args = (q, k, v, ids, masks, out_l, lse, dout, block)
    grads = clustered_flash._backward_cuda(*args, True, None)
    again = (fwd(q, k, v, ids, masks, block, with_lse=True),
             clustered_flash._backward_cuda(*args, True, None))
    torch.cuda.synchronize()
    repeat = all(torch.equal(a, b) for a, b in zip((out_l, lse, *grads), (*again[0], *again[1])))
    ref, ref_lse = clustered_flash.clustered_flash_forward_reference(q, k, v, ids, masks, block,
                                                                     with_lse=True)
    want = clustered_flash.clustered_flash_backward_reference(*args, symmetric=True)
    if bf16:
        errs = {"k3a": max((bf16_err(out, ref), bf16_err(out_l, ref)), key=lambda e: e[1]),
                "k3c": max((bf16_err(a, b) for a, b in zip(grads, want)), key=lambda e: e[1])}
    else:
        errs = {"k3a": (max((out - ref).abs().max().item(), (out_l - ref).abs().max().item()),) * 2,
                "k3c": (max((a - b).abs().max().item() for a, b in zip(grads, want)),) * 2}
        errs = {"k3a": (errs["k3a"][0], errs["k3a"][0] / K3A_TOL),
                "k3c": (errs["k3c"][0], errs["k3c"][0] / K3_BWD_TOL)}
    lse_err = (lse - ref_lse).abs().max().item()
    empty = ~masks.reshape(n_pad, -1).bool().any(-1)  # no neighbour, or padding
    zeros = all(bool((t[:, empty] == 0).all()) for t in (out, out_l, *grads))
    ms = {
        "k3a": cuda_ms(lambda: fwd(q, k, v, ids, masks, block, False)),
        "k3a_lse": cuda_ms(lambda: fwd(q, k, v, ids, masks, block, True)),
        "k3c": cuda_ms(lambda: clustered_flash._backward_cuda(*args, True, None)),
    }
    plain_ms = {
        "k3a": cuda_ms(lambda: clustered_flash.clustered_flash_forward_reference(
            q, k, v, ids, masks, block), runs=3, batch=2),
        "k3c": cuda_ms(lambda: clustered_flash.clustered_flash_backward_reference(
            *args, symmetric=True), runs=3, batch=2),
    }
    q_b = q.reshape(nb, block, heads, c).transpose(1, 2).detach().requires_grad_(True)
    k_b, v_b = (t[0, ids.long()].transpose(1, 2).detach().requires_grad_(True) for t in (k, v))
    attend = masks.bool()[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backend = sdpa_backend(q_b, k_b, v_b, attend)
    with torch.no_grad():
        sdpa_ms = cuda_ms(lambda: sdpa(q_b, k_b, v_b, attn_mask=attend))
    o_b = sdpa(q_b, k_b, v_b, attn_mask=attend)
    do_b = dout.reshape(nb, block, heads, c).transpose(1, 2)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(o_b, (q_b, k_b, v_b), do_b, retain_graph=True))
    del q_b, k_b, v_b, o_b, ref, want
    ctas = {kind: clustered_flash.ctas_per_sm(kind, c, block, u_pad, dtype)
            for kind in ("forward", "dq", "symmetric_dkv")}
    n_edges = khop.senders.shape[0]
    fwd_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, ids, masks, out))
    bwd_bytes = sum(t.numel() * t.element_size() for t in (*args[:-1], *grads))
    rule = bf16_bound if bf16 else bound
    fwd_bound, bwd_bound = rule(4 * n_edges * heads * c, fwd_bytes), rule(10 * n_edges * heads * c, bwd_bytes)
    name = "bf16" if bf16 else "f32"
    print(f"[k3_fgn] c={c} {name}: nb={nb} U_pad={u_pad} heads={heads} | max_abs_err K3a "
          f"{errs['k3a'][0]:.3e} K3c {errs['k3c'][0]:.3e} (of the limit: {errs['k3a'][1]:.3f}, "
          f"{errs['k3c'][1]:.3f}) lse {lse_err:.3e} | empty rows {int(empty.sum())} zeros={zeros} | "
          f"bit-equal repeat {repeat} | ms K3a {ms['k3a']:.4f} (with lse {ms['k3a_lse']:.4f}) K3c "
          f"{ms['k3c']:.4f} | plain K3a {plain_ms['k3a']:.4f} K3c {plain_ms['k3c']:.4f} | SDPA "
          f"{sdpa_ms:.4f} backward {sdpa_bwd_ms:.4f} (backend {backend}) | bound K3a "
          f"{fwd_bound[0]:.4f} ({fwd_bound[1]}) K3c {bwd_bound[0]:.4f} ({bwd_bound[1]}) | CTAs an SM "
          + " ".join(f"{kind} {n}" for kind, n in ctas.items()), flush=True)
    for kernel, (_, ratio) in errs.items():
        if not (ratio <= 1.0):
            raise AssertionError(f"{kernel} {name} c={c}: error {ratio} x its limit")
    if not (lse_err <= K3A_TOL and zeros and repeat):
        raise AssertionError(f"K3 {name} c={c}: lse {lse_err}, empty rows zero {zeros}, "
                             f"bit-equal repeat {repeat}")
    return dict(errs=errs, lse_err=lse_err, ms=ms, plain_ms=plain_ms, sdpa_ms=sdpa_ms,
                sdpa_bwd_ms=sdpa_bwd_ms, backend=backend, ctas=ctas, fwd_bound=fwd_bound,
                bwd_bound=bwd_bound)


def s32_case(segment_sums, name, csr, n_rows, width, gen):
    """S in f32 against its plain version (bit for bit) on edge rows [1,
    n_rows, width] summed through `csr`; CUDA-event medians of the kernel,
    the plain version and index_add_ (atomics: timed only); its bound."""
    offsets, edge_ids = csr
    rows = torch.randn(1, n_rows, width, generator=gen, device="cuda")
    got = segment_sums.edge_order_sum(rows, offsets, edge_ids)
    again = segment_sums.edge_order_sum(rows, offsets, edge_ids)
    want = segment_sums.edge_order_sum_reference(rows, offsets, edge_ids)
    exact = torch.equal(got, want) and torch.equal(got, again)
    nodes = torch.repeat_interleave(torch.arange(offsets.shape[0] - 1, device="cuda"),
                                    (offsets[1:] - offsets[:-1]).long())
    index = torch.empty_like(nodes).scatter_(0, edge_ids.long(), nodes)  # each edge's node
    ms = cuda_ms(lambda: segment_sums.edge_order_sum(rows, offsets, edge_ids))
    plain_ms = cuda_ms(lambda: segment_sums.edge_order_sum_reference(rows, offsets, edge_ids),
                       runs=3, batch=2)
    zeros = torch.zeros_like(got)
    library_ms = cuda_ms(lambda: zeros.index_add(1, index, rows))
    nbytes = sum(t.numel() * t.element_size() for t in (rows, got, offsets, edge_ids))
    err = (got.double() - zeros.index_add(1, index, rows).double()).abs().max().item()
    print(f"[s_f32] {name}: {n_rows} rows x {width} -> {got.shape[1]} nodes | bit-equal to plain "
          f"and repeated {exact} | max |S - index_add_| {err:.3e} | ms {ms:.4f} plain {plain_ms:.4f} "
          f"index_add_ {library_ms:.4f} | bound {bound(n_rows * width, nbytes)[0]:.4f} (bytes)",
          flush=True)
    if not exact:
        raise AssertionError(f"S f32 {name}: not bit-equal to its plain version, or to itself")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound=bound(n_rows * width, nbytes))


def fgn_phases(port, clustered_flash, segment_sums, build, gen) -> dict:
    """Phases 56-61: FGN at bench.py's scale (FGN), f32 and bf16 (see the
    module docstring). Returns what the kernels' JSON line reads. Runs alone
    after `_build.load_libraries(_build.all_sources())`."""
    from graph_weather_tpu_torch.ops.clustered_flash import GENERAL_MAX_CHANNELS

    f32, bf16 = torch.float32, torch.bfloat16
    blocks = FGN["num_blocks"]
    n_lon, n_lat = len(FGN["grid_lon"]), len(FGN["grid_lat"])
    f_in, f_out, zdim = FGN["input_features_dim"], FGN["output_features_dim"], FGN["noise_dimension"]
    # K3's counters (f32; bf16 with the prefix BF16_): every K3a, dq, dk/dv
    # and K3b launch, and the K3a, dq and dk/dv launches at c = 768 apart.
    k3_counters = ("LAUNCHES", "SYMMETRIC_DQ_LAUNCHES", "SYMMETRIC_DKV_LAUNCHES",
                   "GENERAL_BWD_LAUNCHES", "WIDE_LAUNCHES", "WIDE_SYMMETRIC_DQ_LAUNCHES",
                   "WIDE_SYMMETRIC_DKV_LAUNCHES")
    counters = k3_counters + tuple("BF16_" + n for n in k3_counters)

    def counts():  # K3's counters, then S's (f32, bf16)
        return {**{n: getattr(clustered_flash, n) for n in counters},
                "S_F32": segment_sums.F32_LAUNCHES, "S_BF16": segment_sums.LAUNCHES}

    def zero_counts():
        for n in counters:
            setattr(clustered_flash, n, 0)
        segment_sums.F32_LAUNCHES = segment_sums.LAUNCHES = 0

    def made_since(before):
        return {n: v - before[n] for n, v in counts().items()}

    def expect(dtype, k3a=0, dq=0, dkv=0, s=0, wide=(0, 0, 0)):
        """The counts() increments of FGN work in `dtype` (never K3b); `wide`:
        the K3a, dq and dk/dv launches at c = 768 among them."""
        prefix = "" if dtype == f32 else "BF16_"
        want = dict.fromkeys(counts(), 0)
        want.update({prefix + n: v for n, v in zip(k3_counters, (k3a, dq, dkv, 0, *wide))})
        want["S_F32" if dtype == f32 else "S_BF16"] = s
        return want

    def nonzero(made):
        return {n: v for n, v in made.items() if v}

    def device_ms(table, kernel):  # profiled [ms, launches] of `kernel`: all, and at c = 768
        rows = [(name, ms, n) for name, (ms, n) in table.items() if f"::{kernel}<" in name]
        wide = [(ms, n) for name, ms, n in rows if re.search(r"\b768\b", name)]
        return (sum(ms for _, ms, _ in rows), sum(n for _, _, n in rows),
                sum(ms for ms, _ in wide), sum(n for _, n in wide))

    # 56. build: the W768 instantiations (started with the others in phase 2)
    t56 = time.perf_counter()
    wide = [line for name in ("clustered_flash", "clustered_flash_bwd")
            for line in ptxas_by_kernel(build, name) if "<768" in line]
    print("[build] K3a's and K3c's c = 768 tiles (phase 2's build; registers and spills by "
          "instantiation <CP, RG, CS, TK or TB, stages[, role]>): " + " | ".join(wide or ["(no log)"]),
          flush=True)
    if any("bytes spill" in line and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads", line)
           for line in wide):
        print("[build] note: a c = 768 instantiation spills (printed above)", flush=True)
    mma = {name: mma_by_function(build, name, "Li768E") for name in ("clustered_flash", "clustered_flash_bwd")}
    print("[build] tensor-core instructions of the c = 768 instantiations (HMMA ... TF32 in f32, "
          "... BF16 in bf16; SASS by cuobjdump): " + " | ".join(
              f"{name} {args} {kind} {n}" for name, found in mma.items() for args, kind, n in found)
          if any(mma.values()) else "[build] c = 768 SASS not read (no cuobjdump, or no such function)",
          flush=True)
    for name, found in mma.items():
        for kind in ("TF32", "BF16"):
            if found and not sum(n for _, k, n in found if k == kind):
                raise AssertionError(f"{name}.cu: no {kind} tensor-core instruction in its c = 768 "
                                     "instantiations")

    # 57. K3a and K3c at FGN's head widths on its splits-6, 6-hop layout; S in f32
    fgn = port.FunctionalGenerativeNetwork(**FGN, device="cuda")
    graph_s = time.perf_counter() - t56
    khop = fgn.khop
    nb, u_pad = khop.cluster_ids.shape
    print(f"[fgn] graphs (SciPy k-hop) + layout {graph_s:.2f} s | mesh nodes {khop.n_receivers} | "
          f"k-hop edges {khop.senders.shape[0]} | g2m {fgn.g2m.senders.shape[0]} | m2g "
          f"{fgn.m2g.senders.shape[0]} | nb {nb} x {khop.cluster_block} | U_pad {u_pad} | mask "
          f"density {khop.cluster_masks.float().mean().item():.4f} | sum routes (f32) g2m "
          f"{fgn.g2m.sum_route(f32)} k-hop {khop.sum_route(f32)} m2g {fgn.m2g.sum_route(f32)}",
          flush=True)
    if (khop.n_receivers, khop.senders.shape[0], nb, u_pad) != (40962, 5156760, 161, 1024):
        raise AssertionError(f"splits-6 layout: {khop.n_receivers} nodes, {khop.senders.shape[0]} "
                             f"edges, nb {nb}, U_pad {u_pad}")
    if not khop.cluster_symmetric:
        raise AssertionError("FGN's k-hop graph is not symmetric")
    k3 = {(c, dtype): k3_fgn_case(clustered_flash, khop, gen, c, dtype)
          for dtype in (f32, bf16) for c in FGN_WIDTHS}
    s32 = {
        "g2m receivers": s32_case(segment_sums, "g2m receivers (the aggregation)", fgn.g2m.receiver_csr,
                                  fgn.g2m.senders.shape[0], 768, gen),
        "m2g senders": s32_case(segment_sums, "m2g senders (a gather's gradient)", fgn.m2g.sender_csr,
                                fgn.m2g.senders.shape[0], 768, gen),
    }

    def per_member(dtype, field, key):
        return sum(k3[(c, dtype)][field][key] * n for c, n in FGN_WIDTHS.items())

    print(f"[k3_fgn] per member forward / train step, composed of these single-launch times "
          f"(23 x c=192 + c=768): f32 K3a "
          f"{per_member(f32, 'ms', 'k3a'):.4f} ms K3c {per_member(f32, 'ms', 'k3c'):.4f} | bf16 K3a "
          f"{per_member(bf16, 'ms', 'k3a'):.4f} K3c {per_member(bf16, 'ms', 'k3c'):.4f} | K3b's general "
          f"dk/dv stops at c = {GENERAL_MAX_CHANNELS} | phase {time.perf_counter() - t56:.1f} s",
          flush=True)

    # 58-59. serving: member requests at B = 1, the 8-member ensemble, an ensemble rollout
    fgn.init(torch.Generator().manual_seed(0))
    data = torch.Generator().manual_seed(1)
    prev = torch.randn(4, 1, n_lon, n_lat, f_in, generator=data).to("cuda")
    z = torch.randn(4, 1, zdim, generator=data).to("cuda")
    roll = port.FunctionalGenerativeNetwork(**{**FGN, "output_features_dim": f_in}, device="cuda")
    roll.init(torch.Generator().manual_seed(2))
    serve = {}
    for phase, dtype in ((58, f32), (59, bf16)):
        t0 = time.perf_counter()
        name = "f32" if dtype == f32 else "bf16"
        member = torch.no_grad()(fgn.member_fn(compute_dtype=dtype))
        member(prev[0], z[0])  # warm-up
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        request_ms = []
        per_request = expect(dtype, k3a=blocks, s=FGN_S_PER_FORWARD, wide=(1, 0, 0))
        for x, zz in zip(prev[1:], z[1:]):
            before = counts()
            out, ms = timed(lambda: member(x, zz))
            request_ms.append(ms)
            if made_since(before) != per_request:
                raise AssertionError(f"an FGN {name} member request made {nonzero(made_since(before))} "
                                     f"launches, expected {nonzero(per_request)}")
            if out.shape != (1, n_lon, n_lat, f_out) or out.dtype != f32 or not torch.isfinite(out).all():
                raise AssertionError(f"bad FGN {name} output {out.dtype} {tuple(out.shape)}")
        launches = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        table = {}
        kernels = profile_request(lambda: member(x, zz), f"FGN {name} member request", table)
        k3a_device = device_ms(table, "clustered_flash_kernel")
        ensemble = torch.no_grad()(fgn.forward_fn(FGN_MEMBERS, compute_dtype=dtype, member_chunk=1))
        before = counts()
        ens, ens_ms = timed(lambda: ensemble(prev[1], torch.Generator(device="cuda").manual_seed(3)))
        if made_since(before) != expect(dtype, k3a=FGN_MEMBERS * blocks, s=FGN_MEMBERS * FGN_S_PER_FORWARD,
                                        wide=(FGN_MEMBERS, 0, 0)):
            raise AssertionError(f"the {name} ensemble made {nonzero(made_since(before))} launches")
        if ens.shape != (1, FGN_MEMBERS, n_lon, n_lat, f_out) or not torch.isfinite(ens).all() \
                or torch.equal(ens[:, 0], ens[:, 1]):
            raise AssertionError(f"bad {name} ensemble {tuple(ens.shape)}, or equal members")
        spread = ens.std(1).mean().item()
        rollout = torch.no_grad()(roll.ensemble_rollout_fn(2, 2, compute_dtype=dtype, member_chunk=1))
        before = counts()
        traj, roll_ms = timed(lambda: rollout(prev[1], torch.Generator(device="cuda").manual_seed(4)))
        if made_since(before) != expect(dtype, k3a=4 * blocks, s=4 * FGN_S_PER_FORWARD, wide=(4, 0, 0)):
            raise AssertionError(f"the {name} ensemble rollout made {nonzero(made_since(before))} launches")
        if traj.shape != (1, 2, 2, n_lon, n_lat, f_in) or not torch.isfinite(traj).all():
            raise AssertionError(f"bad {name} ensemble rollout {tuple(traj.shape)}")
        serve[name] = dict(request_ms=request_ms, launches=launches, kernels=kernels, peak=peak,
                           member_ms=ens_ms / FGN_MEMBERS, ensemble_ms=ens_ms, step_ms=roll_ms / 2,
                           out=out.cpu(), k3a_device=k3a_device)
        print(f"[fgn_serve_{name}] member request_ms (B=1) {[round(t, 3) for t in request_ms]} | "
              f"{blocks} K3a (1 at c = 768: counted {launches[('' if dtype == f32 else 'BF16_') + 'WIDE_LAUNCHES']} "
              f"in the 3) and {FGN_S_PER_FORWARD} S launch each | profiled request: K3a device ms "
              f"{k3a_device[0]:.3f} over {k3a_device[1]} launches, at c = 768 {k3a_device[2]:.3f} over "
              f"{k3a_device[3]} | peak GiB {peak:.2f} | "
              f"{FGN_MEMBERS}-member ensemble (member_chunk=1) {ens_ms:.3f} ms = "
              f"{ens_ms / FGN_MEMBERS:.3f} ms per member, member spread {spread:.4f} | 2-member "
              f"2-step ensemble rollout {roll_ms:.3f} ms = {roll_ms / 2:.3f} ms per step "
              f"({roll_ms / 4:.3f} per member-step) | phase {phase} {time.perf_counter() - t0:.1f} s",
              flush=True)
        del ens, traj, member, ensemble, rollout
    del roll
    torch.cuda.empty_cache()

    # 60. training: 3 remat steps of bench.py's fgn_member_train_ms (MSE, AdamW at 1e-4), bf16, f32
    target = torch.randn(1, n_lon, n_lat, f_out, generator=data).to("cuda")

    def mse(pred, tgt):
        return torch.mean((pred - tgt) ** 2)

    weights = {k: v.detach().clone() for k, v in fgn.module.state_dict().items()}
    train = {}
    for dtype in (bf16, f32):
        t0 = time.perf_counter()
        name = "f32" if dtype == f32 else "bf16"
        remat = port.FunctionalGenerativeNetwork(**FGN, remat=True, device="cuda")
        remat.module.load_state_dict(weights)
        member = remat.member_fn(compute_dtype=dtype)
        step = port.make_train_step(remat.module.parameters(), member, mse, port.make_optimizer(1e-4))
        before_params = [t.detach().clone() for t in remat.module.parameters()]
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        step_ms, losses = [], []
        per_step = expect(dtype, k3a=2 * blocks, dq=blocks, dkv=blocks, s=FGN_S_PER_STEP, wide=(2, 1, 1))
        for _ in range(3):
            before = counts()
            loss, ms = timed(lambda: step(prev[1], z[1], target))
            if made_since(before) != per_step:
                raise AssertionError(f"an FGN {name} remat train step made {nonzero(made_since(before))} "
                                     f"launches, expected {nonzero(per_step)}")
            if not torch.isfinite(loss):
                raise AssertionError(f"FGN {name} train loss {loss.item()}")
            step_ms.append(ms)
            losses.append(loss.item())
        launches = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        unchanged = sum(torch.equal(a, b) for a, b in zip(before_params, remat.module.parameters()))
        if unchanged or any(t.dtype != f32 for t in remat.module.parameters()):
            raise AssertionError(f"{unchanged} FGN parameter tensors unchanged in 3 {name} steps, "
                                 "or a parameter left f32")
        table = {}
        kernels = profile_request(lambda: step(prev[1], z[1], target), f"FGN {name} remat train step",
                                  table)
        k3c_device = device_ms(table, "clustered_flash_bwd_kernel")

        def objective(member=member):
            return mse(member(prev[2], z[2]), target)

        remat.module.zero_grad(set_to_none=True)
        value = objective()
        value.backward()
        grads = {k: t.grad.cpu() for k, t in remat.module.named_parameters()}
        repeat = card_repeat(remat.module, objective, value.item(), grads, required=True)
        train[name] = dict(step_ms=step_ms, launches=launches, kernels=kernels, peak=peak,
                           k3c_device=k3c_device)
        print(f"[fgn_train_{name}] 3 remat steps | step_ms {[round(t, 3) for t in step_ms]} | steady "
              f"median {statistics.median(step_ms[1:]):.3f} | loss {[round(v, 6) for v in losses]} | "
              f"launches per step K3a {2 * blocks} (with lse; remat recomputes each block), K3c dq "
              f"{blocks}, K3c dk/dv {blocks}, K3b 0, S {FGN_S_PER_STEP}; at c = 768 2, 1 and 1 | "
              f"profiled step: K3c device ms {k3c_device[0]:.3f} over {k3c_device[1]} launches, at "
              f"c = 768 {k3c_device[2]:.3f} over {k3c_device[3]} | all parameter tensors "
              f"changed | peak GiB {peak:.2f} | {repeat} | phase 60 {time.perf_counter() - t0:.1f} s",
              flush=True)
        del remat, step, member, before_params, grads
        torch.cuda.empty_cache()

    # 61. card against CPU at full width, 2 blocks (one at c = 192, the last at c = 768)
    t61 = time.perf_counter()
    short = {**FGN, "num_blocks": FGN_CHECK_BLOCKS}
    card2 = port.FunctionalGenerativeNetwork(**short, device="cuda")
    card2.init(torch.Generator().manual_seed(5))
    cpu2 = port.FunctionalGenerativeNetwork(**short, device="cpu")
    cpu2.module.load_state_dict({k: v.cpu() for k, v in card2.module.state_dict().items()})
    x, zz, tgt = prev[3], z[3], target

    def value_and_grads(model, dtype, state=None):
        model.module.zero_grad(set_to_none=True)
        dev = model.device
        out = model.member_fn(compute_dtype=dtype)((x if state is None else state).to(dev), zz.to(dev))
        value = mse(out, tgt.to(dev))
        value.backward()
        grads = {k: t.grad.cpu() for k, t in model.module.named_parameters()}
        model.module.zero_grad(set_to_none=True)
        return out.detach().cpu(), value.item(), grads

    card32, card16 = value_and_grads(card2, f32), value_and_grads(card2, bf16)
    t0 = time.perf_counter()
    cpu32 = value_and_grads(cpu2, f32)
    cpu32_s = time.perf_counter() - t0
    out_err = (card32[0] - cpu32[0]).abs().max().item()
    loss_rel = abs(card32[1] - cpu32[1]) / abs(cpu32[1])
    worst, worst_name = grads_close(card32[2], cpu32[2])
    print(f"[cpu] FGN f32 at {FGN_CHECK_BLOCKS} blocks: max |out card - CPU| {out_err:.3e} (limit "
          f"{CPU_TOL}) | loss card {card32[1]:.6f} cpu {cpu32[1]:.6f} rel {loss_rel:.3e} (limit "
          f"{LOSS_RTOL}) | gradients: worst error / limit {worst:.3e} ({worst_name}) over "
          f"{len(cpu32[2])} tensors | cpu forward+backward {cpu32_s:.2f} s", flush=True)
    if not (out_err <= CPU_TOL and loss_rel <= LOSS_RTOL and worst <= 1.0):
        raise AssertionError(f"FGN f32 card vs CPU: out {out_err}, loss {loss_rel}, gradient of "
                             f"{worst_name} {worst} x its limit")
    t0 = time.perf_counter()
    cpu16 = value_and_grads(cpu2, bf16)
    cpu16_s = time.perf_counter() - t0
    # The same input with one bf16 ulp on 1 in 2,000 elements (one_ulp_off):
    # how far it moves the card's own bf16 run, and beside a miss the CPU's.
    flipped, n_flips = one_ulp_off(x, 10)
    card_flip = value_and_grads(card2, bf16, state=flipped)

    def distances(a, b):
        return {"output": rmse(a[0], b[0]),
                "gradients": global_norm({k: a[2][k] - b[2][k] for k in a[2]})}

    scale = distances(card16, card32)  # card bf16 - card f32
    ratios, card_own = ({k: v / scale[k] for k, v in distances(a, b).items()}
                        for a, b in ((card16, cpu16), (card16, card_flip)))
    limits = {"output": BF16_CARD_RULE, "gradients": BF16_CARD_GRAD_RULE}
    own = {}
    if any(ratios[k] > limits[k] for k in ratios):
        # Never below the rule of phases 49-50: the larger of 0.5 and the
        # CPU's own reading.
        cpu_flip = value_and_grads(cpu2, bf16, state=flipped)
        own = {k: v / scale[k] for k, v in distances(cpu16, cpu_flip).items()}
        limits = {k: max(limit, 0.5, own[k]) for k, limit in limits.items()}
    print(f"[cpu] FGN bf16 at {FGN_CHECK_BLOCKS} blocks: RMSE card bf16 - CPU bf16 over card bf16 - "
          f"card f32: output {ratios['output']:.3f} gradients (global norm) {ratios['gradients']:.3f} "
          f"(limits {limits['output']:.3f}, {limits['gradients']:.3f}: GenCast's, or beside a miss the "
          f"larger of 0.5 and the CPU's own reading) | one bf16 ulp on {n_flips} of {x.numel()} "
          f"inputs moves the card's bf16 run output {card_own['output']:.3f} gradients "
          f"{card_own['gradients']:.3f}" + (f", the CPU's {own['output']:.3f} and "
                                             f"{own['gradients']:.3f}" if own else "")
          + f" | loss card {card16[1]:.6f} cpu {cpu16[1]:.6f} f32 {card32[1]:.6f} | cpu bf16 "
          f"forward+backward {cpu16_s:.2f} s | phase 61 {time.perf_counter() - t61:.1f} s", flush=True)
    for key, ratio in ratios.items():
        if not (ratio <= limits[key]):
            raise AssertionError(f"FGN bf16 card vs CPU ({key}): {ratio} > {limits[key]}")
    del card2, cpu2, fgn
    torch.cuda.empty_cache()
    return dict(k3=k3, s32=s32, serve=serve, train=train)


def main() -> int:
    # A fatal signal (a crash in native code) prints the Python stack first.
    faulthandler.enable()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import graph_weather_tpu_torch as port

    if not Path(port.__file__).resolve().is_relative_to(ROOT):
        raise ImportError(f"graph_weather_tpu_torch imported from {port.__file__}, not {ROOT}")
    from graph_weather_tpu_torch.meshes.graphs import (
        build_grid_to_mesh_graph,
        build_latent_graph,
        build_mesh_to_grid_graph,
    )
    from graph_weather_tpu_torch.meshes.clustering import build_cluster_scatter_index
    from graph_weather_tpu_torch.meshes.hexmesh import get_hexmesh
    from graph_weather_tpu_torch.models.gencast.graphs import build_graphcast_graphs
    from graph_weather_tpu_torch.nn.graph_blocks import DeviceGraph
    from graph_weather_tpu_torch.ops import (
        _build,
        banded_flash,
        clustered_flash,
        edge_mlp,
        fused_mlp,
        natten3d,
        natten_flash,
    )
    from graph_weather_tpu_torch.ops import scatter as segment_sums
    from graph_weather_tpu_torch.ops.banded_attention import band_windows, build_band_masks
    from graph_weather_tpu_torch.ops.neighborhood_attention import (
        _window_indices,
        neighborhood_attention_3d,
        neighborhood_attention_3d_reference,
    )
    from graph_weather_tpu_torch.train.rollout import make_rollout_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = smi
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # 2. build (all kernels at once; phase 7 reports the second)
    t0 = time.perf_counter()
    _build.load_libraries(_build.all_sources())
    build_s = time.perf_counter() - t0

    def ptxas(name):
        log = _build.build_log_path(name)
        if not log.exists():
            return ["(cached build, no log)"]
        return [line.strip() for line in log.read_text().splitlines()
                if "registers" in line or "spill" in line]

    print(f"[build] edge_mlp.cu {build_s:.2f} s | "
          + " | ".join(ptxas("edge_mlp") + [tf32_mma_report(_build, "edge_mlp")]), flush=True)

    # 3. K1 and K2 at the main-path shapes, on the real 1° graphs
    lat_lons = grid(1.0)
    ll = np.asarray(lat_lons)
    mesh = get_hexmesh(2)
    g2m, latent, m2g = (
        build_grid_to_mesh_graph(ll, mesh),
        build_latent_graph(mesh),
        build_mesh_to_grid_graph(ll, mesh),
    )
    sizes = (g2m.n_edges, latent.n_edges, m2g.n_edges)
    if sizes != (64800, 41162, 452460):
        raise AssertionError(f"1° graph edge counts {sizes}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1 = {
        name: k1_case(edge_mlp, name, bundle, with_dst, gen)
        for name, bundle, with_dst in (
            ("g2m", g2m, True), ("latent", latent, True), ("m2g", m2g, False)
        )
    }
    k1_launches_phase3 = edge_mlp.LAUNCHES  # the checked calls and the timings

    def per_forward(values):
        return sum(values[n] * c for n, c in EDGE_UPDATES.items())

    k1_ms = per_forward({n: v[1] for n, v in k1.items()})
    k1_plain_ms = per_forward({n: v[2] for n, v in k1.items()})
    k1_bound_ms = per_forward({n: bound(*v[3:])[0] for n, v in k1.items()})
    k1_bound_by = bound(*k1["m2g"][3:])[1]
    print(f"[k1] per forward (g2m + 9 latent + m2g): kernel_ms={k1_ms:.4f} "
          f"plain_ms={k1_plain_ms:.4f} bound_ms={k1_bound_ms:.4f} ({k1_bound_by})", flush=True)
    def main_path_graphs():
        """The three 1° graphs on the card, with the node-sum tables (built
        here and in phase 33, so that no later phase's peak holds them)."""
        return {name: DeviceGraph.from_bundle(bundle, "cuda", edge_sums=True)
                for name, bundle in (("g2m", g2m), ("latent", latent), ("m2g", m2g))}

    device_graphs = main_path_graphs()
    k2 = {name: k2_case(fused_mlp, name, device_graphs[name], name != "m2g", gen)
          for name in EDGE_UPDATES}
    del device_graphs
    k2_ms = per_forward({n: v[1] for n, v in k2.items()})
    k2_plain_ms = per_forward({n: v[2] for n, v in k2.items()})
    k2_bound_ms = per_forward({n: bound(*v[3:])[0] for n, v in k2.items()})
    k2_bound_by = bound(*k2["m2g"][3:])[1]
    k2_gflop = per_forward({n: v[3] for n, v in k2.items()}) / 1e9
    print(f"[k2] per forward (g2m + 9 latent + m2g): kernel_ms={k2_ms:.4f} "
          f"plain_ms={k2_plain_ms:.4f} bound_ms={k2_bound_ms:.4f} ({k2_bound_by}: "
          f"{k2_gflop:.1f} GFLOP) tf32x3_bound_ms="
          f"{per_forward({n: tf32x3_ms(v[3]) for n, v in k2.items()}):.4f} | K1 (raw mode) "
          f"kernel_ms={k1_ms:.4f}", flush=True)

    # 4. serve
    t0 = time.perf_counter()
    model = port.GraphWeatherForecaster(
        lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cuda"
    )
    model.init(torch.Generator().manual_seed(0))
    setup_s = time.perf_counter() - t0
    inputs = torch.randn(
        3, 1, len(lat_lons), FEATURE_DIM + AUX_DIM, generator=torch.Generator().manual_seed(1)
    ).to("cuda")
    loss_fn = port.NormalizedMSELoss(np.ones(FEATURE_DIM), lat_lons, device="cuda")
    edge_mlp.LAUNCHES = fused_mlp.LAUNCHES = clustered_flash.LAUNCHES = 0
    request_ms, losses = [], []
    for features in inputs:
        before = fused_mlp.LAUNCHES
        pred, ms = timed(lambda: model(features))
        request_ms.append(ms)
        if fused_mlp.LAUNCHES - before != 11 or edge_mlp.LAUNCHES:
            raise AssertionError(f"{fused_mlp.LAUNCHES - before} K2 launches, expected 11; "
                                 f"{edge_mlp.LAUNCHES} K1 launches, expected 0")
        if pred.shape != (1, len(lat_lons), FEATURE_DIM) or not torch.isfinite(pred).all():
            raise AssertionError(f"bad prediction: shape {tuple(pred.shape)}")
        losses.append(loss_fn(pred, features[..., :FEATURE_DIM]).item())
    serve_launches, serve_k1_launches = fused_mlp.LAUNCHES, edge_mlp.LAUNCHES
    print(f"[serve] setup {setup_s:.2f} s | request_ms {[round(t, 3) for t in request_ms]} "
          f"| K2 launches {serve_launches}, K1 {serve_k1_launches} | loss {[round(v, 6) for v in losses]}", flush=True)
    request_kernels = profile_request(lambda: model(features), "forecaster request")  # for phase 49

    # 5. the same weights and the last request on the CPU
    cpu_model = port.GraphWeatherForecaster(
        lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cpu"
    )
    cpu_model.module.load_state_dict({k: v.cpu() for k, v in model.module.state_dict().items()})
    t0 = time.perf_counter()
    cpu_pred = cpu_model(features.cpu())
    cpu_s = time.perf_counter() - t0
    cpu_err = (pred.cpu() - cpu_pred).abs().max().item()
    print(f"[cpu] max_abs_diff {cpu_err:.3e} (limit {CPU_TOL}) | cpu forward {cpu_s:.2f} s",
          flush=True)
    if not (cpu_err <= CPU_TOL):
        raise AssertionError(f"card vs CPU: {cpu_err} > {CPU_TOL}")

    # 6. rollout
    rollout = make_rollout_fn(model, 4)
    before = fused_mlp.LAUNCHES
    traj, ms = timed(lambda: rollout(inputs[0]))
    step_ms = ms / 4
    if traj.shape != (4, 1, len(lat_lons), FEATURE_DIM) or not torch.isfinite(traj).all():
        raise AssertionError(f"bad rollout: shape {tuple(traj.shape)}")
    if fused_mlp.LAUNCHES - before != 44 or edge_mlp.LAUNCHES:
        raise AssertionError(f"rollout made {fused_mlp.LAUNCHES - before} K2 launches, expected 44")
    print(f"[rollout] 4 steps finite | step_ms {step_ms:.3f} | K2 launches 44", flush=True)
    del model, cpu_model, traj

    # 7. build of the GenCast kernel (started with the others in phase 2)
    print(f"[build] clustered_flash.cu {build_s:.2f} s (parallel with edge_mlp.cu) | "
          + " | ".join(ptxas("clustered_flash") + [tf32_mma_report(_build, "clustered_flash")]),
          flush=True)

    # 8. K3a on the real splits-5 layout, at the processor's two head widths
    t0 = time.perf_counter()
    graphs = build_graphcast_graphs(
        GENCAST["grid_lon"], GENCAST["grid_lat"], splits=5, num_hops=4,
        add_edge_features_to_khop=False, spatial_sort="rcb",
    )
    khop = DeviceGraph.from_bundle(graphs.khop, "cuda", clustered=True)
    graph_s = time.perf_counter() - t0
    nb, u_pad = khop.cluster_ids.shape
    block = khop.cluster_block

    def empty_tiles(tq, tk):  # share of (query tile, key tile) pairs without an edge
        m = khop.cluster_masks.bool().reshape(nb, block // tq, tq, u_pad // tk, tk)
        return 1.0 - m.any(4).any(2).float().mean().item()

    print(f"[k3a] graphs (SciPy k-hop) + layout {graph_s:.2f} s | k-hop edges "
          f"{graphs.khop.n_edges} | g2m {graphs.g2m.n_edges} | m2g {graphs.m2g.n_edges} | "
          f"nb {nb} | U_pad {u_pad} | mask density "
          f"{khop.cluster_masks.float().mean().item():.4f} | empty key tiles "
          f"64x64 {empty_tiles(64, 64):.4f} 32x32 {empty_tiles(32, 32):.4f} 16x16 "
          f"{empty_tiles(16, 16):.4f} (K3's warp tiles)", flush=True)
    k3a = {c: k3a_case(clustered_flash, khop, gen, c) for c in (128, 512)}
    per_eval = {128: GENCAST["num_blocks"] - 1, 512: 1}  # launches per denoiser evaluation

    def per_eval_sum(values):
        return sum(values[c] * n for c, n in per_eval.items())

    k3a_ms = per_eval_sum({c: v[1] for c, v in k3a.items()})
    k3a_plain_ms = per_eval_sum({c: v[2] for c, v in k3a.items()})
    k3a_sdpa_ms = per_eval_sum({c: v[3] for c, v in k3a.items()})
    k3a_bound_ms = per_eval_sum({c: bound(*v[4:])[0] for c, v in k3a.items()})
    k3a_bound_by = bound(*k3a[128][4:])[1]
    dense_flops = per_eval_sum({c: 4 * nb * 256 * u_pad * c * 4 for c in per_eval})
    print(f"[k3a] per denoiser eval (15 x c=128 + c=512): kernel_ms={k3a_ms:.4f} "
          f"plain_ms={k3a_plain_ms:.4f} sdpa_ms={k3a_sdpa_ms:.4f} bound_ms={k3a_bound_ms:.4f} "
          f"({k3a_bound_by}, edges only) | dense (row, slot) work {dense_flops / 1e9:.1f} GFLOP "
          f"= {dense_flops / FP32_PEAK * 1e3:.3f} ms at the FP32 peak", flush=True)

    # 9. denoise: the full-width Denoiser answers 3 requests
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    den = port.Denoiser(**GENCAST, device="cuda")
    den.init(torch.Generator().manual_seed(0))
    setup_s = time.perf_counter() - t0
    data_gen = torch.Generator().manual_seed(1)
    n_lon, n_lat, f_in, f_out = 128, 64, GENCAST["input_features_dim"], GENCAST["output_features_dim"]
    corrupted = torch.randn(3, 1, n_lon, n_lat, f_out, generator=data_gen).to("cuda")
    prev = torch.randn(3, 1, n_lon, n_lat, 2 * f_in, generator=data_gen).to("cuda")
    sigma = torch.ones(1, 1, device="cuda")
    edge_mlp.LAUNCHES = fused_mlp.LAUNCHES = clustered_flash.LAUNCHES = 0
    segment_sums.F32_LAUNCHES = 0
    denoise_ms = []
    for x, cond in zip(corrupted, prev):
        before = clustered_flash.LAUNCHES, segment_sums.F32_LAUNCHES
        out, ms = timed(lambda: den(x, cond, sigma))
        denoise_ms.append(ms)
        made = clustered_flash.LAUNCHES - before[0], segment_sums.F32_LAUNCHES - before[1]
        if made != (GENCAST["num_blocks"], 1):
            raise AssertionError(f"{made} K3a and f32 S launches, expected 16 and 1 (the g2m "
                                 "aggregation in edge order)")
        if out.shape != (1, n_lon, n_lat, f_out) or not torch.isfinite(out).all():
            raise AssertionError(f"bad denoiser output: shape {tuple(out.shape)}")
    denoise_launches, gencast_s32_launches = clustered_flash.LAUNCHES, segment_sums.F32_LAUNCHES
    if edge_mlp.LAUNCHES or fused_mlp.LAUNCHES:
        raise AssertionError("the GenCast path launched K1 or K2")
    print(f"[denoise] setup {setup_s:.2f} s | request_ms {[round(t, 3) for t in denoise_ms]} "
          f"| K3a launches {denoise_launches}, f32 S {gencast_s32_launches} | peak GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f}", flush=True)
    profile_request(lambda: den(x, cond, sigma))
    # Phase 28 serves the same requests with these weights through the
    # banded attention (phase 15 trains den further). Kept on the host, so
    # that the peak memory of the phases between is the model's own.
    weights9 = {k: v.detach().cpu() for k, v in den.module.state_dict().items()}
    clustered_out = out.detach().cpu()
    requests9 = (corrupted, prev, sigma)  # phase 45 serves them again, in bf16

    # 10. the same weights and the last request on the CPU
    cpu_den = port.Denoiser(**GENCAST, device="cpu")
    cpu_den.module.load_state_dict({k: v.cpu() for k, v in den.module.state_dict().items()})
    t0 = time.perf_counter()
    cpu_out = cpu_den(x.cpu(), cond.cpu(), sigma.cpu())
    cpu_s = time.perf_counter() - t0
    cpu_err = (out.cpu() - cpu_out).abs().max().item()
    print(f"[cpu] denoiser max_abs_diff {cpu_err:.3e} (limit {CPU_TOL}) | cpu forward "
          f"{cpu_s:.2f} s", flush=True)
    if not (cpu_err <= CPU_TOL):
        raise AssertionError(f"denoiser card vs CPU: {cpu_err} > {CPU_TOL}")
    del cpu_den

    # 11. sample: 2 samples of the 20-step sampler
    sampler = port.Sampler(num_steps=20, device="cuda")
    noise_gen = torch.Generator(device="cuda").manual_seed(2)
    sample_ms = []
    for _ in range(2):
        before = clustered_flash.LAUNCHES
        sample, ms = timed(lambda: sampler.sample(den, prev[0], noise_gen))
        sample_ms.append(ms)
        launches = clustered_flash.LAUNCHES - before
        if launches != EVALS_PER_SAMPLE * GENCAST["num_blocks"]:
            raise AssertionError(f"a sample made {launches} K3a launches, expected 592")
        if sample.shape != (1, n_lon, n_lat, f_out) or not torch.isfinite(sample).all():
            raise AssertionError(f"bad sample: shape {tuple(sample.shape)}")
    print(f"[sample] 2 x 20 steps ({EVALS_PER_SAMPLE} evals) finite | sample_ms "
          f"{[round(t, 3) for t in sample_ms]} | ms per eval {sample_ms[-1] / EVALS_PER_SAMPLE:.3f} "
          f"| K3a launches {launches} per sample", flush=True)

    # 12. a 2-step AR sample rollout
    ar = port.make_ar_rollout_fn(sampler, den, 2, device="cuda")
    traj, ms = timed(lambda: ar(prev[0], noise_gen))
    if traj.shape != (2, 1, n_lon, n_lat, f_out) or not torch.isfinite(traj).all():
        raise AssertionError(f"bad AR rollout: shape {tuple(traj.shape)}")
    print(f"[ar_rollout] 2 steps finite | ms per AR step {ms / 2:.3f}", flush=True)

    # 13. build of the backward kernels (started with the others in phase 2)
    print(f"[build] clustered_flash_bwd.cu {build_s:.2f} s (parallel with the others) | "
          + " | ".join(ptxas("clustered_flash_bwd") + [tf32_mma_report(_build, "clustered_flash_bwd")]),
          flush=True)

    # 14. K3c and K3b on the real splits-5 layout, at both head widths
    # The k-hop graph is symmetric, so its DeviceGraph carries no inverse
    # index; K3b's comes from the layout here, outside the timings.
    scatter = torch.as_tensor(build_cluster_scatter_index(
        khop.cluster_ids.cpu().numpy(), khop.cluster_masks.cpu().numpy(), khop.n_senders
    ), device="cuda")
    bwd = {c: k3_bwd_case(clustered_flash, khop, scatter, gen, c) for c in (128, 512)}
    k3b_phase14 = sum(v["k3b_launches"] for v in bwd.values())
    k3c_ms = per_eval_sum({c: v["ms"]["k3c"] for c, v in bwd.items()})
    k3b_ms = per_eval_sum({c: v["ms"]["k3b"] for c, v in bwd.items()})
    k3c_plain_ms = per_eval_sum({c: v["plain"]["k3c"] for c, v in bwd.items()})
    k3b_plain_ms = per_eval_sum({c: v["plain"]["k3b"] for c, v in bwd.items()})
    bwd_sdpa_ms = per_eval_sum({c: v["sdpa_ms"] for c, v in bwd.items()})
    bwd_bound_ms = per_eval_sum({c: bound(v["flops"], v["nbytes"])[0] for c, v in bwd.items()})
    bwd_bound_by = bound(bwd[128]["flops"], bwd[128]["nbytes"])[1]
    dense_bwd = per_eval_sum({c: 7 * 2 * nb * 256 * u_pad * c * 4 for c in per_eval})
    print(f"[k3_bwd] per train step (15 x c=128 + c=512): K3c_ms={k3c_ms:.4f} K3b_ms={k3b_ms:.4f} "
          f"plain_ms K3c {k3c_plain_ms:.4f} K3b {k3b_plain_ms:.4f} sdpa_bwd_ms={bwd_sdpa_ms:.4f} "
          f"bound_ms={bwd_bound_ms:.4f} ({bwd_bound_by}, edges only) | dense (row, slot) work of "
          f"K3c's 7 products {dense_bwd / 1e9:.1f} GFLOP = {dense_bwd / FP32_PEAK * 1e3:.3f} ms at "
          f"the FP32 peak", flush=True)

    # 15. train: 3 steps of the full-width denoiser (the weights of phase 9)
    train_gen = torch.Generator().manual_seed(3)
    corrupted_t, prev_t, target_t = (
        torch.randn(1, n_lon, n_lat, f, generator=train_gen).to("cuda") for f in (f_out, 2 * f_in, f_out)
    )
    noise_t = port.sample_noise_level(torch.Generator(device="cuda").manual_seed(4), (1, 1))
    train_loss = port.WeightedMSELoss(grid_lat=GENCAST["grid_lat"], device="cuda")

    def objective(pred, target):
        return train_loss(pred, noise_t, target)

    def counts():
        return (clustered_flash.LAUNCHES, clustered_flash.SYMMETRIC_DQ_LAUNCHES,
                clustered_flash.SYMMETRIC_DKV_LAUNCHES, clustered_flash.GENERAL_BWD_LAUNCHES)

    def train_steps(model, n_steps, per_step, counts=counts, names="K3a, K3c dq, K3c dk/dv, K3b"):
        """n_steps of make_train_step on `model`; each must make `per_step`
        launches of the kernels that `counts` reads. Returns (step, ms, losses)."""
        step = port.make_train_step(
            model.module.parameters(), model.forward_fn(), objective, port.make_optimizer(1e-4)
        )
        step_ms, losses = [], []
        for _ in range(n_steps):
            before = counts()
            loss, ms = timed(lambda: step(corrupted_t, prev_t, noise_t, target_t))
            made = tuple(a - b for a, b in zip(counts(), before))
            if made != per_step:
                raise AssertionError(f"a train step made {made} ({names}) launches, "
                                     f"expected {per_step}")
            if not torch.isfinite(loss):
                raise AssertionError(f"train loss {loss.item()}")
            step_ms.append(ms)
            losses.append(loss.item())
        return step, step_ms, losses

    blocks = GENCAST["num_blocks"]
    before = [t.detach().clone() for t in den.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    clustered_flash.LAUNCHES = clustered_flash.SYMMETRIC_DQ_LAUNCHES = 0
    clustered_flash.SYMMETRIC_DKV_LAUNCHES = clustered_flash.GENERAL_BWD_LAUNCHES = 0
    step, train_ms, train_losses = train_steps(den, 3, (blocks, blocks, blocks, 0))
    train_launches = counts()
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [i for i, (a, b) in enumerate(zip(before, den.module.parameters())) if torch.equal(a, b)]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} parameter tensors did not change in 3 train steps")
    print(f"[train] 3 steps | step_ms {[round(t, 3) for t in train_ms]} | steady median "
          f"{statistics.median(train_ms[1:]):.3f} | loss {[round(v, 6) for v in train_losses]} "
          f"| sigma {noise_t.item():.4f} | launches per step K3a {blocks} K3c dq {blocks} "
          f"K3c dk/dv {blocks} K3b 0 | all {len(before)} parameter tensors changed | "
          f"peak GiB {train_peak:.2f}", flush=True)
    profile_request(lambda: step(corrupted_t, prev_t, noise_t, target_t), "train step")
    del step
    remat = port.Denoiser(**GENCAST, remat=True, device="cuda")
    remat.module.load_state_dict(den.module.state_dict())
    torch.cuda.reset_peak_memory_stats()
    _, remat_ms, remat_loss = train_steps(remat, 2, (2 * blocks, blocks, blocks, 0))
    print(f"[train] remat=True: 2 steps | step_ms {[round(t, 3) for t in remat_ms]} | loss "
          f"{[round(v, 6) for v in remat_loss]} | K3a launches {2 * blocks} per step | peak GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} (with the first model's weights and "
          f"optimizer state resident)", flush=True)
    del remat

    # 16. the same weights and batch: gradients on the card and on the CPU
    den.module.zero_grad(set_to_none=True)
    card_value = objective(den.forward_fn()(corrupted_t, prev_t, noise_t), target_t)
    card_value.backward()
    card_grads = {k: t.grad.cpu() for k, t in den.module.named_parameters()}
    repeat = card_repeat(den.module, lambda: objective(den.forward_fn()(corrupted_t, prev_t, noise_t),
                                                       target_t), card_value.item(), card_grads,
                         required=True)
    # Card against CPU at GENCAST_CHECK_BLOCKS blocks (the trained weights).
    short = shallow_denoiser(port, GENCAST, den.module, "cuda")
    short_value = objective(short.forward_fn()(corrupted_t, prev_t, noise_t), target_t)
    short_value.backward()
    short_grads = {k: t.grad.cpu() for k, t in short.module.named_parameters()}
    cpu_den = shallow_denoiser(port, GENCAST, den.module, "cpu")
    del short
    cpu_loss = port.WeightedMSELoss(grid_lat=GENCAST["grid_lat"], device="cpu")
    t0 = time.perf_counter()
    cpu_value = cpu_loss(cpu_den.forward_fn()(corrupted_t.cpu(), prev_t.cpu(), noise_t.cpu()),
                         noise_t.cpu(), target_t.cpu())
    cpu_value.backward()
    cpu_s = time.perf_counter() - t0
    cpu_grads = {k: t.grad for k, t in cpu_den.module.named_parameters()}
    loss_rel = abs(short_value.item() - cpu_value.item()) / abs(cpu_value.item())
    worst, worst_name = grads_close(short_grads, cpu_grads)
    print(f"[cpu] {GENCAST_CHECK_BLOCKS} blocks: train loss card {short_value.item():.6f} cpu "
          f"{cpu_value.item():.6f} rel "
          f"{loss_rel:.3e} (limit {LOSS_RTOL}) | gradients: worst error / limit {worst:.3e} "
          f"({worst_name}) over {len(cpu_grads)} tensors | cpu forward+backward {cpu_s:.2f} s | "
          f"{repeat}", flush=True)
    if not (loss_rel <= LOSS_RTOL):
        raise AssertionError(f"train loss card vs CPU: {loss_rel} > {LOSS_RTOL}")
    if not (worst <= 1.0):
        raise AssertionError(f"gradient of {worst_name} card vs CPU: {worst} x its limit")
    graphs_khop_edges = graphs.khop.n_edges
    # Phase 47 takes the bf16 gradients at these weights and this batch, and
    # holds them against these f32 ones.
    weights16 = {k: v.detach().cpu() for k, v in den.module.state_dict().items()}
    grads16, batch16, objective16 = card_grads, (corrupted_t, prev_t, noise_t, target_t), objective
    card_value16 = card_value.item()
    del cpu_den, den, sampler, ar, khop, graphs, scatter
    torch.cuda.empty_cache()

    # 17. build of the NATTEN kernels (started with the others in phase 2)
    print(f"[build] natten_flash.cu + natten_flash_bwd.cu {build_s:.2f} s (parallel with the "
          "others) | K5a: " + " | ".join(ptxas_by_kernel(_build, "natten_flash")) + " | K5b: "
          + " | ".join(ptxas("natten_flash_bwd")), flush=True)

    # 18. K5a on WeatherMesh's 1-degree latent: (a) the model's layers, (b) a
    # circular W axis, (c) the JAX module's default kernel and heads, (d) the
    # widest head K5a takes; K5b (phase 22) takes (a)-(c)
    cases = {
        "a": ((3, 5, 5), 4, False), "b": ((3, 5, 5), 4, True), "c": ((5, 7, 7), 8, False),
    }
    k5a = {n: k5a_case(natten_flash, neighborhood_attention_3d_reference, n, gen, *c)
           for n, c in {**cases, "d": ((3, 5, 5), 4, False, 128)}.items()}
    k5a_bound, k5a_bound_by = bound(k5a["a"]["flops"], k5a["a"]["nbytes"])
    print(f"[k5a] per forward ({K5_PER_FORWARD} x case a): kernel_ms="
          f"{K5_PER_FORWARD * k5a['a']['ms']:.4f} plain_ms={K5_PER_FORWARD * k5a['a']['plain_ms']:.4f} "
          f"sdpa_ms={K5_PER_FORWARD * k5a['a']['sdpa_ms']:.4f} bound_ms="
          f"{K5_PER_FORWARD * k5a_bound:.4f} ({k5a_bound_by}: {k5a['a']['flops'] / 1e9:.2f} GFLOP, "
          f"{k5a['a']['nbytes'] / 1e6:.1f} MB per launch)", flush=True)

    # 19. wm_serve: the full-size WeatherMesh answers 3 requests
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wm = port.WeatherMesh(**WEATHERMESH, device="cuda")
    wm.init(torch.Generator().manual_seed(0))
    # The attention projections' biases at 0: with TorchLinear's uniform
    # biases, eight layers of window averaging leave some decoder channels
    # nearly constant over the grid, and their GroupNorm amplifies f32
    # rounding by orders of magnitude: card and CPU then differ by ~6e-2 at
    # 1 deg, by ~5e-4 with these biases at 0 (NVIDIA H100 80GB HBM3 host).
    with torch.no_grad():
        for name, t in wm.module.named_parameters():
            if name.endswith(("qkv.bias", "proj.bias")):
                t.zero_()
    setup_s = time.perf_counter() - t0
    h, w = WM_GRID
    levels = WEATHERMESH["pressure_levels"]
    wm_gen = torch.Generator().manual_seed(1)
    surfaces = torch.randn(3, 1, h, w, 8, generator=wm_gen).to("cuda")
    pressures = torch.randn(3, 1, levels, h, w, 4, generator=wm_gen).to("cuda")
    natten_flash.LAUNCHES = natten_flash.BWD_DQ_LAUNCHES = natten_flash.BWD_DKV_LAUNCHES = 0
    natten3d.LAUNCHES = 0
    wm_ms = []
    for surface, pressure in zip(surfaces, pressures):
        before = natten_flash.LAUNCHES
        pred, ms = timed(lambda: wm(surface, pressure))
        wm_ms.append(ms)
        if natten_flash.LAUNCHES - before != K5_PER_FORWARD:
            raise AssertionError(f"{natten_flash.LAUNCHES - before} K5a launches, expected 8")
        if (pred.surface.shape != (1, h, w, 8) or pred.pressure.shape != (1, levels, h, w, 4)
                or not (torch.isfinite(pred.surface).all() and torch.isfinite(pred.pressure).all())):
            raise AssertionError(f"bad WeatherMesh output: {tuple(pred.surface.shape)}, "
                                 f"{tuple(pred.pressure.shape)}")
    wm_launches = natten_flash.LAUNCHES
    if natten_flash.BWD_DQ_LAUNCHES or natten_flash.BWD_DKV_LAUNCHES:
        raise AssertionError("serving launched K5b")
    if natten3d.LAUNCHES:
        raise AssertionError(f"the 128-d WeatherMesh launched K6 {natten3d.LAUNCHES} times")
    print(f"[wm_serve] setup {setup_s:.2f} s | request_ms {[round(t, 3) for t in wm_ms]} | K5a "
          f"launches {wm_launches}, K6 0 | peak GiB {torch.cuda.max_memory_allocated() / 2**30:.2f}",
          flush=True)
    profile_request(lambda: wm(surface, pressure), "WeatherMesh request")

    # 20. the same weights and the last request on the CPU
    cpu_wm = port.WeatherMesh(**WEATHERMESH, device="cpu")
    cpu_wm.module.load_state_dict({k: v.cpu() for k, v in wm.module.state_dict().items()})
    t0 = time.perf_counter()
    cpu_pred = cpu_wm(surface.cpu(), pressure.cpu())
    cpu_s = time.perf_counter() - t0
    cpu_err = max((pred.surface.cpu() - cpu_pred.surface).abs().max().item(),
                  (pred.pressure.cpu() - cpu_pred.pressure).abs().max().item())
    print(f"[cpu] WeatherMesh max_abs_diff {cpu_err:.3e} (limit {CPU_TOL}) | cpu forward "
          f"{cpu_s:.2f} s", flush=True)
    if not (cpu_err <= CPU_TOL):
        raise AssertionError(f"WeatherMesh card vs CPU: {cpu_err} > {CPU_TOL}")
    del cpu_pred

    # 21. an 8-step rollout (bench.py's weathermesh_rollout_ms_per_step)
    before = natten_flash.LAUNCHES
    roll, ms = timed(lambda: wm(surface, pressure, forecast_steps=8))
    roll_launches = natten_flash.LAUNCHES - before
    if roll_launches != 4 + 8 * WEATHERMESH["processor_num_layers"]:
        raise AssertionError(f"the rollout made {roll_launches} K5a launches, expected 36")
    if not (torch.isfinite(roll.surface).all() and torch.isfinite(roll.pressure).all()):
        raise AssertionError("the 8-step rollout is not finite")
    print(f"[wm_rollout] 8 steps finite | total_ms {ms:.3f} | ms per step {ms / 8:.3f} | K5a "
          f"launches {roll_launches}", flush=True)
    del roll

    # 22. K5b against the plain backward in the cases of phase 18
    k5b = {n: k5b_case(natten_flash, n, gen, *c) for n, c in cases.items()}
    k5b_bound, k5b_bound_by = bound(k5b["a"]["flops"], k5b["a"]["nbytes"])
    k5b_split_bound = {kind: bound(k5b["a"]["flops_split"][kind], k5b["a"]["nbytes_split"][kind])
                       for kind in ("dq", "dkv")}
    print(f"[k5b] per train step ({K5_PER_FORWARD} x case a): kernels_ms="
          f"{K5_PER_FORWARD * k5b['a']['ms']:.4f} (dq {K5_PER_FORWARD * k5b['a']['split']['dq']:.4f}, "
          f"bound {K5_PER_FORWARD * k5b_split_bound['dq'][0]:.4f} {k5b_split_bound['dq'][1]}; dk/dv "
          f"{K5_PER_FORWARD * k5b['a']['split']['dkv']:.4f}, bound "
          f"{K5_PER_FORWARD * k5b_split_bound['dkv'][0]:.4f} {k5b_split_bound['dkv'][1]}; delta "
          f"{K5_PER_FORWARD * k5b['a']['split']['delta']:.4f}; drpb sum "
          f"{K5_PER_FORWARD * k5b['a']['split']['drpb_sum']:.4f}) "
          f"plain_ms={K5_PER_FORWARD * k5b['a']['plain_ms']:.4f} "
          f"sdpa_bwd_ms={K5_PER_FORWARD * k5b['a']['sdpa_ms']:.4f} bound_ms="
          f"{K5_PER_FORWARD * k5b_bound:.4f} ({k5b_bound_by}: {k5b['a']['flops'] / 1e9:.2f} GFLOP, "
          f"{k5b['a']['nbytes'] / 1e6:.1f} MB per layer) | K5a with lse "
          f"{K5_PER_FORWARD * k5a['a']['lse_ms']:.4f}", flush=True)

    # 23. wm_train: 3 steps of make_train_step with bench.py's objective
    targets = tuple(torch.randn(t.shape, generator=wm_gen).to("cuda") for t in (surface, pressure))

    def wm_objective(pred, tgt):
        return ((pred.surface - tgt[0]) ** 2).mean() + ((pred.pressure - tgt[1]) ** 2).mean()

    def k5_counts():
        return (natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES)

    before_params = [t.detach().clone() for t in wm.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    natten_flash.LAUNCHES = natten_flash.BWD_DQ_LAUNCHES = natten_flash.BWD_DKV_LAUNCHES = 0
    wm_step = port.make_train_step(
        wm.module.parameters(), wm.forward_fn(), wm_objective, port.make_optimizer(1e-4)
    )
    wm_train_ms, wm_losses = [], []
    for _ in range(3):
        before = k5_counts()
        loss, ms = timed(lambda: wm_step(surface, pressure, targets))
        made = tuple(a - b for a, b in zip(k5_counts(), before))
        if made != (K5_PER_FORWARD,) * 3:
            raise AssertionError(f"a train step made {made} (K5a, dq, dk/dv) launches, expected 8 each")
        if not torch.isfinite(loss):
            raise AssertionError(f"WeatherMesh train loss {loss.item()}")
        wm_train_ms.append(ms)
        wm_losses.append(loss.item())
    wm_train_launches = k5_counts()
    wm_train_peak = torch.cuda.max_memory_allocated() / 2**30
    names = [n for n, _ in wm.module.named_parameters()]
    unchanged = [n for n, a, b in zip(names, before_params, wm.module.parameters()) if torch.equal(a, b)]
    if unchanged:
        raise AssertionError(f"parameters unchanged after 3 train steps: {unchanged}")
    print(f"[wm_train] 3 steps | step_ms {[round(t, 3) for t in wm_train_ms]} | steady median "
          f"{statistics.median(wm_train_ms[1:]):.3f} | loss {[round(v, 6) for v in wm_losses]} | "
          f"launches per step K5a 8 dq 8 dk/dv 8 | all {len(names)} parameter tensors changed "
          f"(rpb included) | peak GiB {wm_train_peak:.2f}", flush=True)
    profile_request(lambda: wm_step(surface, pressure, targets), "WeatherMesh train step")
    del wm_step, before_params

    # 24. the same weights and one batch at 3 deg (the weights do not depend
    # on the grid; at 1 deg the CPU's forward alone takes ~1-2 min): gradients
    # on the card and on the CPU
    check_h, check_w = WM_CHECK_GRID
    check = [torch.randn(1, check_h, check_w, 8, generator=wm_gen),
             torch.randn(1, levels, check_h, check_w, 4, generator=wm_gen)]
    check_targets = tuple(torch.randn(t.shape, generator=wm_gen) for t in check)
    wm.module.zero_grad(set_to_none=True)
    card_value = wm_objective(wm.forward_fn()(*(t.cuda() for t in check)),
                              tuple(t.cuda() for t in check_targets))
    card_value.backward()
    card_grads = {k: t.grad.cpu() for k, t in wm.module.named_parameters()}
    repeat = card_repeat(
        wm.module,
        lambda: wm_objective(wm.forward_fn()(*(t.cuda() for t in check)),
                             tuple(t.cuda() for t in check_targets)),
        card_value.item(), card_grads, required=True,
    )
    cpu_wm.module.load_state_dict({k: v.cpu() for k, v in wm.module.state_dict().items()})
    t0 = time.perf_counter()
    cpu_value = wm_objective(cpu_wm.forward_fn()(*check), check_targets)
    cpu_value.backward()
    cpu_s = time.perf_counter() - t0
    cpu_grads = {k: t.grad for k, t in cpu_wm.module.named_parameters()}
    loss_rel = abs(card_value.item() - cpu_value.item()) / abs(cpu_value.item())
    worst, worst_name = grads_close(card_grads, cpu_grads)
    print(f"[cpu] WeatherMesh at {check_h} x {check_w} (3 deg): train loss card {card_value.item():.6f} "
          f"cpu {cpu_value.item():.6f} "
          f"rel {loss_rel:.3e} (limit {LOSS_RTOL}) | gradients: worst error / limit {worst:.3e} "
          f"({worst_name}) over {len(cpu_grads)} tensors | cpu forward+backward {cpu_s:.2f} s | "
          f"{repeat}", flush=True)
    if not (loss_rel <= LOSS_RTOL):
        raise AssertionError(f"WeatherMesh train loss card vs CPU: {loss_rel} > {LOSS_RTOL}")
    if not (worst <= 1.0):
        raise AssertionError(f"WeatherMesh gradient of {worst_name} card vs CPU: {worst} x its limit")
    del cpu_wm, wm
    torch.cuda.empty_cache()

    # 25. build of the banded kernels (started with the others in phase 2)
    print(f"[build] banded_flash.cu + banded_flash_bwd.cu {build_s:.2f} s (parallel with the "
          "others) | " + " | ".join(ptxas("banded_flash") + ptxas("banded_flash_bwd")
                                    + ["banded_flash: " + tf32_mma_report(_build, "banded_flash"),
                                       "banded_flash_bwd: " + tf32_mma_report(_build, "banded_flash_bwd")]),
          flush=True)

    # 26. K4a on the real splits-5 band layout (the lat-lon sorted k-hop
    # graph), at the processor's two head widths
    t0 = time.perf_counter()
    band_graphs = build_graphcast_graphs(
        GENCAST["grid_lon"], GENCAST["grid_lat"], splits=5, num_hops=4,
        add_edge_features_to_khop=False, spatial_sort=True,
    )
    band = DeviceGraph.from_bundle(band_graphs.khop, "cuda", banded=True, band_flash=True)
    graph_s = time.perf_counter() - t0
    band_nb, band_block, band_w = band.band_masks.shape[0], band.band_block, band.band_w
    width = band_block + 2 * band_w

    def band_empty_tiles(tq, tk):  # share of (receiver tile, key tile) pairs without an edge
        m = band.band_masks.bool().reshape(band_nb, band_block // tq, tq, width // tk, tk)
        return 1.0 - m.any(4).any(2).float().mean().item()

    print(f"[k4a] graphs + band layout {graph_s:.2f} s | k-hop edges {band_graphs.khop.n_edges} | "
          f"nb {band_nb} | block {band_block} | w {band_w} | mask "
          f"{tuple(band.band_masks.shape)} {band.band_masks.numel() / 1e6:.1f} MB, density "
          f"{band.band_masks.float().mean().item():.4f} | empty key tiles 64x64 "
          f"{band_empty_tiles(64, 64):.4f} 32x32 {band_empty_tiles(32, 32):.4f} | pairs in 16x16 "
          f"tiles with an edge (K4a's and K4b's warp tiles) {1 - band_empty_tiles(16, 16):.4f}, in "
          f"16x8 {1 - band_empty_tiles(16, 8):.4f} | "
          f"band_symmetric {band.band_symmetric}", flush=True)
    if not band.band_symmetric:
        raise AssertionError("the k-hop graph's band layout is not marked symmetric")
    if band_graphs.khop.n_edges != graphs_khop_edges:
        raise AssertionError("the banded and clustered k-hop graphs differ in their edge count")
    k4a = {c: k4a_case(banded_flash, band_windows, band, gen, c) for c in (128, 512)}
    k4a_ms = per_eval_sum({c: v["ms"] for c, v in k4a.items()})
    k4a_plain_ms = per_eval_sum({c: v["plain_ms"] for c, v in k4a.items()})
    k4a_sdpa_ms = per_eval_sum({c: v["sdpa_ms"] for c, v in k4a.items()})
    k4a_bound_ms = per_eval_sum({c: bound(v["flops"], v["nbytes"])[0] for c, v in k4a.items()})
    k4a_bound_by = bound(k4a[128]["flops"], k4a[128]["nbytes"])[1]
    k4a_tf32x3 = per_eval_sum({c: tf32x3_ms(v["flops"]) for c, v in k4a.items()})
    print(f"[k4a] per denoiser eval (15 x c=128 + c=512): kernel_ms={k4a_ms:.4f} "
          f"plain_ms={k4a_plain_ms:.4f} sdpa_ms={k4a_sdpa_ms:.4f} bound_ms={k4a_bound_ms:.4f} "
          f"({k4a_bound_by}, edges only; three TF32 products at {TF32_PEAK / 1e12:.0f} TFLOP/s: "
          f"{k4a_tf32x3:.4f}) | with lse "
          f"{per_eval_sum({c: v['lse_ms'] for c, v in k4a.items()}):.4f} | K3a (phase 8) "
          f"{k3a_ms:.4f}", flush=True)

    # 27. K4b in the same cases, both roles of its dk/dv kernel; then the
    # general role on a directed band
    general_before = banded_flash.BWD_DKV_LAUNCHES
    k4b = {c: k4b_case(banded_flash, band_windows, band, gen, c) for c in (128, 512)}
    k4b_general_phase27 = banded_flash.BWD_DKV_LAUNCHES - general_before
    k4b_directed_err = max(k4b_directed_case(banded_flash, build_band_masks, gen, c) for c in (128, 512))
    k4b_ms = {kind: per_eval_sum({c: v["ms"][kind] for c, v in k4b.items()})
              for kind in ("dq", "dkv", "dkv_general", "all")}
    k4b_plain_ms = per_eval_sum({c: v["plain_ms"] for c, v in k4b.items()})
    k4b_sdpa_ms = per_eval_sum({c: v["sdpa_ms"] for c, v in k4b.items()})
    k4b_bound = {
        kind: (per_eval_sum({c: bound(v["flops"][kind], v["nbytes"][kind])[0] for c, v in k4b.items()}),
               bound(k4b[128]["flops"][kind], k4b[128]["nbytes"][kind])[1])
        for kind in ("dq", "dkv")
    }
    k4b_tf32x3 = {kind: per_eval_sum({c: tf32x3_ms(v["flops"][kind]) for c, v in k4b.items()})
                  for kind in ("dq", "dkv")}
    print(f"[k4b] per train step (15 x c=128 + c=512): dq_ms={k4b_ms['dq']:.4f} "
          f"dkv_ms={k4b_ms['dkv']:.4f} (symmetric; general {k4b_ms['dkv_general']:.4f}) "
          f"backward_ms={k4b_ms['all']:.4f} plain_ms={k4b_plain_ms:.4f} "
          f"sdpa_bwd_ms={k4b_sdpa_ms:.4f} bound_ms dq {k4b_bound['dq'][0]:.4f} ({k4b_bound['dq'][1]}) "
          f"dk/dv {k4b_bound['dkv'][0]:.4f} ({k4b_bound['dkv'][1]}) | three TF32 products at "
          f"{TF32_PEAK / 1e12:.0f} TFLOP/s: dq {k4b_tf32x3['dq']:.4f} dk/dv {k4b_tf32x3['dkv']:.4f} "
          f"| K3c (phase 14) {k3c_ms:.4f}", flush=True)
    del band, band_graphs
    torch.cuda.empty_cache()

    # 28. band_serve: phase 9's weights and requests through the banded Denoiser
    def band_counts():
        return (banded_flash.LAUNCHES, banded_flash.BWD_DQ_LAUNCHES,
                banded_flash.BWD_DKV_SYMMETRIC_LAUNCHES, banded_flash.BWD_DKV_LAUNCHES,
                clustered_flash.LAUNCHES + clustered_flash.SYMMETRIC_DQ_LAUNCHES
                + clustered_flash.SYMMETRIC_DKV_LAUNCHES + clustered_flash.GENERAL_BWD_LAUNCHES)

    def zero_band_counts():
        banded_flash.LAUNCHES = banded_flash.BWD_DQ_LAUNCHES = banded_flash.BWD_DKV_LAUNCHES = 0
        banded_flash.BWD_DKV_SYMMETRIC_LAUNCHES = 0
        clustered_flash.LAUNCHES = clustered_flash.SYMMETRIC_DQ_LAUNCHES = 0
        clustered_flash.SYMMETRIC_DKV_LAUNCHES = clustered_flash.GENERAL_BWD_LAUNCHES = 0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bden = port.Denoiser(**GENCAST_BANDED, device="cuda")
    bden.module.load_state_dict(weights9)
    setup_s = time.perf_counter() - t0
    zero_band_counts()
    band_ms = []
    for x, cond in zip(corrupted, prev):
        before = band_counts()
        bout, ms = timed(lambda: bden(x, cond, sigma))
        band_ms.append(ms)
        made = tuple(a - b for a, b in zip(band_counts(), before))
        if made != (GENCAST["num_blocks"], 0, 0, 0, 0):
            raise AssertionError(f"a banded request made {made} (K4a, K4b dq, K4b dk/dv symmetric, "
                                 "K4b dk/dv general, K3) launches, expected (16, 0, 0, 0, 0)")
        if bout.shape != (1, n_lon, n_lat, f_out) or not torch.isfinite(bout).all():
            raise AssertionError(f"bad banded denoiser output: shape {tuple(bout.shape)}")
    band_launches = banded_flash.LAUNCHES
    band_peak = torch.cuda.max_memory_allocated() / 2**30
    vs_clustered = (bout.cpu() - clustered_out).abs().max().item()
    print(f"[band_serve] setup {setup_s:.2f} s (w {bden.khop.band_w}) | request_ms "
          f"{[round(t, 3) for t in band_ms]} | K4a launches {band_launches} | peak GiB "
          f"{band_peak:.2f} | max_abs_diff from the clustered Denoiser (phase 9) {vs_clustered:.3e} "
          f"(limit {CPU_TOL})", flush=True)
    if not (vs_clustered <= CPU_TOL):
        raise AssertionError(f"banded vs clustered denoiser: {vs_clustered} > {CPU_TOL}")
    profile_request(lambda: bden(x, cond, sigma), "banded request")
    plain_den = port.Denoiser(**{**GENCAST, "attention_impl": "banded"}, device="cuda")
    plain_den.module.load_state_dict(weights9)
    plain_den(x, cond, sigma)  # warm-up
    before = band_counts()
    _, plain_request_ms = timed(lambda: plain_den(x, cond, sigma))
    if band_counts() != before:
        raise AssertionError("attention_impl='banded' launched a kernel")
    print(f"[band_serve] attention_impl='banded' (plain PyTorch): request_ms "
          f"{plain_request_ms:.3f} (timed only)", flush=True)
    del plain_den
    torch.cuda.empty_cache()

    # 29. the same weights and the last request on the CPU
    cpu_bden = port.Denoiser(**GENCAST_BANDED, device="cpu")
    cpu_bden.module.load_state_dict(weights9)
    t0 = time.perf_counter()
    cpu_bout = cpu_bden(x.cpu(), cond.cpu(), sigma.cpu())
    cpu_s = time.perf_counter() - t0
    cpu_err = (bout.cpu() - cpu_bout).abs().max().item()
    print(f"[cpu] banded denoiser max_abs_diff {cpu_err:.3e} (limit {CPU_TOL}) | cpu forward "
          f"{cpu_s:.2f} s", flush=True)
    if not (cpu_err <= CPU_TOL):
        raise AssertionError(f"banded denoiser card vs CPU: {cpu_err} > {CPU_TOL}")

    # 30. band_train: 3 steps on the banded Denoiser, then 2 with remat
    names = "K4a, K4b dq, K4b dk/dv symmetric, K4b dk/dv general, K3"
    before_params = [t.detach().clone() for t in bden.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    zero_band_counts()
    # The k-hop graph is symmetric: the dk/dv kernel takes its symmetric role.
    step, band_train_ms, band_losses = train_steps(bden, 3, (blocks, blocks, blocks, 0, 0),
                                                   band_counts, names)
    band_train_launches = band_counts()
    band_train_peak = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [i for i, (a, b) in enumerate(zip(before_params, bden.module.parameters())) if torch.equal(a, b)]
    if unchanged:
        raise AssertionError(f"{len(unchanged)} parameter tensors did not change in 3 banded train steps")
    print(f"[band_train] 3 steps | step_ms {[round(t, 3) for t in band_train_ms]} | steady median "
          f"{statistics.median(band_train_ms[1:]):.3f} | loss {[round(v, 6) for v in band_losses]} | "
          f"launches per step K4a {blocks} dq {blocks} dk/dv {blocks} (symmetric role) K3 0 | all "
          f"{len(before_params)} parameter tensors changed | peak GiB {band_train_peak:.2f}", flush=True)
    profile_request(lambda: step(corrupted_t, prev_t, noise_t, target_t), "banded train step")
    del step, before_params
    remat = port.Denoiser(**GENCAST_BANDED, remat=True, device="cuda")
    remat.module.load_state_dict(bden.module.state_dict())
    torch.cuda.reset_peak_memory_stats()
    _, remat_ms, remat_loss = train_steps(remat, 2, (2 * blocks, blocks, blocks, 0, 0), band_counts,
                                          names)
    print(f"[band_train] remat=True: 2 steps | step_ms {[round(t, 3) for t in remat_ms]} | loss "
          f"{[round(v, 6) for v in remat_loss]} | K4a launches {2 * blocks} per step | peak GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} (with the first model's weights and "
          f"optimizer state resident)", flush=True)
    del remat

    # 31. the same weights and batch: gradients on the card and on the CPU
    bden.module.zero_grad(set_to_none=True)
    card_value = objective(bden.forward_fn()(corrupted_t, prev_t, noise_t), target_t)
    card_value.backward()
    # Card against CPU at GENCAST_CHECK_BLOCKS blocks (the trained weights).
    short = shallow_denoiser(port, GENCAST_BANDED, bden.module, "cuda")
    short.module.zero_grad(set_to_none=True)
    card_value = objective(short.forward_fn()(corrupted_t, prev_t, noise_t), target_t)
    card_value.backward()
    card_grads = {k: t.grad.cpu() for k, t in short.module.named_parameters()}
    cpu_bden = shallow_denoiser(port, GENCAST_BANDED, bden.module, "cpu")
    del short
    t0 = time.perf_counter()
    cpu_value = cpu_loss(cpu_bden.forward_fn()(corrupted_t.cpu(), prev_t.cpu(), noise_t.cpu()),
                         noise_t.cpu(), target_t.cpu())
    cpu_value.backward()
    cpu_s = time.perf_counter() - t0
    cpu_grads = {k: t.grad for k, t in cpu_bden.module.named_parameters()}
    loss_rel = abs(card_value.item() - cpu_value.item()) / abs(cpu_value.item())
    worst, worst_name = grads_close(card_grads, cpu_grads)
    print(f"[cpu] banded train loss card {card_value.item():.6f} cpu {cpu_value.item():.6f} rel "
          f"{loss_rel:.3e} (limit {LOSS_RTOL}) | gradients: worst error / limit {worst:.3e} "
          f"({worst_name}) over {len(cpu_grads)} tensors | cpu forward+backward {cpu_s:.2f} s "
          f"({GENCAST_CHECK_BLOCKS} blocks)", flush=True)
    if not (loss_rel <= LOSS_RTOL):
        raise AssertionError(f"banded train loss card vs CPU: {loss_rel} > {LOSS_RTOL}")
    if not (worst <= 1.0):
        raise AssertionError(f"banded gradient of {worst_name} card vs CPU: {worst} x its limit")
    del cpu_bden, bden  # weights9 stays on the host for phase 45
    torch.cuda.empty_cache()

    # 32. build of K2b (started with the others in phase 2)
    print(f"[build] fused_mlp_bwd.cu {build_s:.2f} s (parallel with the others) | "
          + " | ".join(ptxas("fused_mlp_bwd") + [tf32_mma_report(_build, "fused_mlp_bwd")]),
          flush=True)

    # 33. K2b with the sums after it, at the main-path shapes
    device_graphs = main_path_graphs()
    k2b = {name: k2b_case(fused_mlp, name, device_graphs[name], name != "m2g", gen)
           for name in EDGE_UPDATES}
    k2b_ms = {kind: per_forward({n: v["ms"][kind] for n, v in k2b.items()})
              for kind in ("kernel", "backward", "plain")}
    k2b_bound_ms = per_forward({n: bound(v["flops"], v["nbytes"])[0] for n, v in k2b.items()})
    k2b_bound_by = bound(k2b["m2g"]["flops"], k2b["m2g"]["nbytes"])[1]
    k2b_gflop = per_forward({n: v["flops"] for n, v in k2b.items()}) / 1e9
    print(f"[k2b] per train step (g2m + 9 latent + m2g): kernel_ms={k2b_ms['kernel']:.4f} "
          f"backward_ms={k2b_ms['backward']:.4f} plain_ms={k2b_ms['plain']:.4f} bound_ms="
          f"{k2b_bound_ms:.4f} ({k2b_bound_by}: {k2b_gflop:.1f} GFLOP) tf32x3_bound_ms="
          f"{per_forward({n: tf32x3_ms(v['flops']) for n, v in k2b.items()}):.4f}", flush=True)
    del device_graphs
    torch.cuda.empty_cache()

    # 34. fc_train: bench.py's metric_train_step on the 1° forecaster
    def fc_counts():
        return fused_mlp.LAUNCHES, fused_mlp.BACKWARD_LAUNCHES, edge_mlp.LAUNCHES

    fc_gen = torch.Generator().manual_seed(5)
    fc_x = torch.randn(1, len(lat_lons), FEATURE_DIM + AUX_DIM, generator=fc_gen).to("cuda")
    fc_y = torch.randn(1, len(lat_lons), FEATURE_DIM, generator=fc_gen).to("cuda")
    fc_loss = port.NormalizedMSELoss(np.ones(FEATURE_DIM), lat_lons, normalize=True, device="cuda")

    def fc_train_steps(model, n_steps, per_step):
        """n_steps of make_train_step; each must make `per_step` (K2, K2b, K1)
        launches. Returns (step, ms per step, losses)."""
        step = port.make_train_step(
            model.module.parameters(), model.forward_fn(), fc_loss, port.make_optimizer(1e-3)
        )
        step_ms, step_losses = [], []
        for _ in range(n_steps):
            before = fc_counts()
            loss, ms = timed(lambda: step(fc_x, fc_y))
            made = tuple(a - b for a, b in zip(fc_counts(), before))
            if made != per_step:
                raise AssertionError(f"a forecaster train step made {made} (K2, K2b, K1) launches, "
                                     f"expected {per_step}")
            if not torch.isfinite(loss):
                raise AssertionError(f"forecaster train loss {loss.item()}")
            step_ms.append(ms)
            step_losses.append(loss.item())
        return step, step_ms, step_losses

    torch.cuda.reset_peak_memory_stats()
    fc = port.GraphWeatherForecaster(lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cuda")
    fc.init(torch.Generator().manual_seed(0))
    fc_initial = {k: v.cpu() for k, v in fc.module.state_dict().items()}  # for phase 35
    fc_before = [t.detach().clone() for t in fc.module.parameters()]
    edge_mlp.LAUNCHES = fused_mlp.LAUNCHES = fused_mlp.BACKWARD_LAUNCHES = 0
    fc_step, fc_ms, fc_losses = fc_train_steps(fc, 3, (11, 11, 0))
    fc_launches = fc_counts()
    fc_peak = torch.cuda.max_memory_allocated() / 2**30
    names = [n for n, _ in fc.module.named_parameters()]
    unchanged = [n for n, a, b in zip(names, fc_before, fc.module.parameters()) if torch.equal(a, b)]
    if unchanged:
        raise AssertionError(f"forecaster parameters unchanged after 3 train steps: {unchanged}")
    print(f"[fc_train] 3 steps | step_ms {[round(t, 3) for t in fc_ms]} | steady median "
          f"{statistics.median(fc_ms[1:]):.3f} | loss {[round(v, 6) for v in fc_losses]} | "
          f"launches per step K2 11 K2b 11 K1 0 | all {len(names)} parameter tensors changed | "
          f"peak GiB {fc_peak:.2f}", flush=True)
    step_kernels = profile_request(lambda: fc_step(fc_x, fc_y), "forecaster train step")
    del fc_step, fc_before
    fc_remat = port.GraphWeatherForecaster(
        lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, use_checkpointing=True, device="cuda"
    )
    fc_remat.module.load_state_dict(fc.module.state_dict())
    torch.cuda.reset_peak_memory_stats()
    _, fc_remat_ms, fc_remat_losses = fc_train_steps(fc_remat, 2, (20, 11, 0))
    print(f"[fc_train] use_checkpointing=True: 2 steps | step_ms {[round(t, 3) for t in fc_remat_ms]} "
          f"| loss {[round(v, 6) for v in fc_remat_losses]} | K2 launches 20 per step (9 "
          f"recomputed) | peak GiB {torch.cuda.max_memory_allocated() / 2**30:.2f} (with the first "
          f"model's weights and optimizer state resident)", flush=True)
    del fc_remat
    torch.cuda.empty_cache()

    # 35. the same weights and batch: gradients on the card and on the CPU,
    # after the train steps and at the initial weights
    def fc_grads(model, loss_fn, x, y):
        model.module.zero_grad(set_to_none=True)
        value = loss_fn(model.forward_fn()(x), y)
        value.backward()
        return value.item(), {k: t.grad.cpu() for k, t in model.module.named_parameters()}

    card_value, card_grads = fc_grads(fc, fc_loss, fc_x, fc_y)
    # A second forward and backward must give the same bits: the edge
    # updates, their backward and the aggregations all add in a fixed order
    # (the aggregations through the graphs' padded-CSR levels).
    repeat_value, repeat_grads = fc_grads(fc, fc_loss, fc_x, fc_y)
    differ = [k for k in card_grads if not torch.equal(card_grads[k], repeat_grads[k])]
    bit_equal = card_value == repeat_value and not differ
    repeat_worst, repeat_worst_name = grads_close(repeat_grads, card_grads)
    del repeat_grads
    cpu_fc = port.GraphWeatherForecaster(lat_lons, feature_dim=FEATURE_DIM, aux_dim=AUX_DIM, device="cpu")
    cpu_fc.module.load_state_dict({k: v.cpu() for k, v in fc.module.state_dict().items()})
    cpu_fc_loss = port.NormalizedMSELoss(np.ones(FEATURE_DIM), lat_lons, normalize=True, device="cpu")
    cpu_x, cpu_y = fc_x.cpu(), fc_y.cpu()
    t0 = time.perf_counter()
    cpu_value, cpu_grads = fc_grads(cpu_fc, cpu_fc_loss, cpu_x, cpu_y)
    cpu_s = time.perf_counter() - t0
    loss_rel = abs(card_value - cpu_value) / abs(cpu_value)
    worst, worst_name = grads_close(card_grads, cpu_grads)
    print(f"[cpu] forecaster train loss card {card_value:.6f} cpu {cpu_value:.6f} rel "
          f"{loss_rel:.3e} (limit {LOSS_RTOL}) | gradients: worst error / limit {worst:.3e} "
          f"({worst_name}) over {len(cpu_grads)} tensors | cpu forward+backward {cpu_s:.2f} s "
          f"(1 deg) | card repeat bit-equal {bit_equal}, against the first: worst error / limit "
          f"{repeat_worst:.3e} ({repeat_worst_name})", flush=True)
    if not bit_equal:
        raise AssertionError(
            f"the card's repeated forecaster loss ({card_value!r}, {repeat_value!r}) or gradients "
            f"differ: {len(differ)} of {len(card_grads)} tensors, {differ[:8]}"
        )
    if not (loss_rel <= LOSS_RTOL):
        raise AssertionError(f"forecaster train loss card vs CPU: {loss_rel} > {LOSS_RTOL}")
    if not (worst <= 1.0):
        raise AssertionError(f"forecaster gradient of {worst_name} card vs CPU: {worst} x its limit")

    # The initial weights (the mesh seeds at 0), where the encoder's
    # gradients are ill-conditioned in f32: the CPU's float64 gradient says
    # how far f32 rounding alone puts them.
    fc.module.load_state_dict(fc_initial)
    cpu_fc.module.load_state_dict(fc_initial)
    card_value, card_grads = fc_grads(fc, fc_loss, fc_x, fc_y)
    cpu_value, cpu_grads = fc_grads(cpu_fc, cpu_fc_loss, cpu_x, cpu_y)
    forecaster_to_float64(cpu_fc)
    t0 = time.perf_counter()
    exact_value, exact_grads = fc_grads(cpu_fc, cpu_fc_loss, cpu_x.double(), cpu_y.double())
    exact_s = time.perf_counter() - t0
    loss_rel = abs(card_value - cpu_value) / abs(cpu_value)
    floor = 1e-6 * max(g.abs().max().item() for g in exact_grads.values())
    f32_worst, f32_worst_name = grads_close(
        {k: g.float() for k, g in cpu_grads.items()}, {k: g.float() for k, g in exact_grads.items()}
    )
    worst, worst_name, outside = grads_near_exact(card_grads, cpu_grads, exact_grads)
    seeds = "Encoder_0.mesh_nodes"
    print(f"[cpu] forecaster at its initial weights: loss card {card_value:.6f} cpu {cpu_value:.6f} "
          f"float64 {exact_value:.6f} rel {loss_rel:.3e} (limit {LOSS_RTOL}) | mesh seeds' max|g| "
          f"{exact_grads[seeds].abs().max().item():.3e}, largest {floor * 1e6:.3e} | CPU float32 "
          f"against float64: worst error / limit {f32_worst:.3e} ({f32_worst_name}) | card against "
          f"CPU: {len(outside)} of {len(cpu_grads)} tensors outside the limit, each as (error / "
          f"limit, card's error / CPU float32's error against float64, in norm): "
          + ", ".join(f"{k} ({r:.3f}, {q:.3f})" for k, r, q in outside)
          + f" | float64 forward+backward {exact_s:.2f} s", flush=True)
    if not (loss_rel <= LOSS_RTOL):
        raise AssertionError(f"initial forecaster loss card vs CPU: {loss_rel} > {LOSS_RTOL}")
    if not (worst <= 1.0):
        raise AssertionError(
            f"initial forecaster gradient of {worst_name}: the card's error against float64 is "
            f"{worst * F32_NOISE_FACTOR:.3f} times the CPU float32's, over {F32_NOISE_FACTOR}"
        )
    del cpu_fc, fc, fc_initial
    torch.cuda.empty_cache()

    # 36. build of K6 (started with the others in phase 2)
    print(f"[build] natten3d.cu {build_s:.2f} s (parallel with the others) | "
          + " | ".join(ptxas("natten3d") + [tf32_mma_report(_build, "natten3d", required=False)]),
          flush=True)

    # 37. K6 on the 1-degree latent: (a) the 768-d model's layers, (b) a
    # circular W axis, (c) the 128-d model's layers through impl="pallas",
    # also against K5a, (d) heads of 256; (e), (f) the other instantiations
    # (16 lanes at 128 channels, 8 lanes at 64)
    t0 = time.perf_counter()
    k6_cases = {
        "a": dict(kernel=(5, 7, 7), heads=8, ch=96, circular=False),
        "b": dict(kernel=(5, 7, 7), heads=8, ch=96, circular=True),
        "c": dict(kernel=(3, 5, 5), heads=4, ch=32, circular=False, via_pallas=True),
        "d": dict(kernel=(3, 5, 5), heads=2, ch=256, circular=False),
        "e": dict(kernel=(5, 7, 7), heads=2, ch=128, circular=False),
        "f": dict(kernel=(3, 5, 5), heads=4, ch=64, circular=False),
    }
    k6 = {n: k6_case(natten3d, natten_flash, neighborhood_attention_3d,
                     neighborhood_attention_3d_reference, _window_indices, n, gen, **c)
          for n, c in k6_cases.items()}
    k6_bound, k6_bound_by = bound(k6["a"]["flops"], k6["a"]["nbytes"])
    print(f"[k6] per request ({K6_PER_FORWARD} x case a): kernel_ms="
          f"{K6_PER_FORWARD * k6['a']['ms']:.4f} plain_ms={K6_PER_FORWARD * k6['a']['plain_ms']:.4f} "
          f"library_ms={K6_PER_FORWARD * k6['a']['library_ms']:.4f} bound_ms="
          f"{K6_PER_FORWARD * k6_bound:.4f} ({k6_bound_by}: {k6['a']['pairs'] / 1e6:.1f} M pairs, "
          f"{k6['a']['flops'] / 1e9:.2f} GFLOP, {k6['a']['nbytes'] / 1e6:.1f} MB per layer; "
          f"{k6_bound:.4f} ms per layer) | phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 38. wm_wide_serve: the 768-d WeatherMesh answers 3 requests
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    wide = port.WeatherMesh(**WM_WIDE, device="cuda")
    wide.init(torch.Generator().manual_seed(0))
    with torch.no_grad():  # as in phase 19
        for name, t in wide.module.named_parameters():
            if name.endswith(("qkv.bias", "proj.bias")):
                t.zero_()
    setup_s = time.perf_counter() - t0
    wm_gen = torch.Generator().manual_seed(1)
    surfaces = torch.randn(3, 1, h, w, 8, generator=wm_gen).to("cuda")
    pressures = torch.randn(3, 1, levels, h, w, 4, generator=wm_gen).to("cuda")
    natten3d.LAUNCHES = natten_flash.LAUNCHES = 0
    wide_ms = []
    for surface, pressure in zip(surfaces, pressures):
        before = (natten3d.LAUNCHES, natten_flash.LAUNCHES)
        pred, ms = timed(lambda: wide(surface, pressure))
        wide_ms.append(ms)
        made = (natten3d.LAUNCHES - before[0], natten_flash.LAUNCHES - before[1])
        if made != (K6_PER_FORWARD, 0):
            raise AssertionError(f"a wide request made {made} (K6, K5a) launches, expected (16, 0)")
        if (pred.surface.shape != (1, h, w, 8) or pred.pressure.shape != (1, levels, h, w, 4)
                or not (torch.isfinite(pred.surface).all() and torch.isfinite(pred.pressure).all())):
            raise AssertionError(f"bad wide WeatherMesh output: {tuple(pred.surface.shape)}, "
                                 f"{tuple(pred.pressure.shape)}")
    wide_launches = natten3d.LAUNCHES
    print(f"[wm_wide_serve] setup {setup_s:.2f} s | request_ms {[round(t, 3) for t in wide_ms]} | "
          f"K6 launches {wide_launches}, K5a {natten_flash.LAUNCHES} | peak GiB "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} | phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    profile_request(lambda: wide(surface, pressure), "wide WeatherMesh request")

    # 39. a 2-step rollout
    t0 = time.perf_counter()
    before = natten3d.LAUNCHES
    roll, ms = timed(lambda: wide(surface, pressure, forecast_steps=2))
    roll_launches = natten3d.LAUNCHES - before
    want = WM_WIDE["encoder_num_transformer_layers"] + 2 * WM_WIDE["processor_num_layers"] + (
        WM_WIDE["decoder_num_transformer_layers"])
    if roll_launches != want:
        raise AssertionError(f"the wide rollout made {roll_launches} K6 launches, expected {want}")
    if not (torch.isfinite(roll.surface).all() and torch.isfinite(roll.pressure).all()):
        raise AssertionError("the wide 2-step rollout is not finite")
    print(f"[wm_wide_rollout] 2 steps finite | total_ms {ms:.3f} | ms per step {ms / 2:.3f} | K6 "
          f"launches {roll_launches} | phase {time.perf_counter() - t0:.1f} s", flush=True)
    del roll, pred

    # 40. the same weights and one request at 28 x 60 on the card and on the CPU
    t0 = time.perf_counter()
    check_h, check_w = WM_WIDE_CHECK_GRID
    check = [torch.randn(1, check_h, check_w, 8, generator=wm_gen),
             torch.randn(1, levels, check_h, check_w, 4, generator=wm_gen)]
    short = shallow_weathermesh(port, WM_WIDE, wide.module, "cuda")  # WM_WIDE_CHECK_LAYERS
    short_k6 = K6_PER_FORWARD - WM_WIDE["processor_num_layers"] + WM_WIDE_CHECK_LAYERS
    before = natten3d.LAUNCHES
    card_pred = short(*(t.cuda() for t in check))
    torch.cuda.synchronize()
    if natten3d.LAUNCHES - before != short_k6:
        raise AssertionError(f"the check request made {natten3d.LAUNCHES - before} K6 launches")
    cpu_wide = shallow_weathermesh(port, WM_WIDE, short.module, "cpu")
    del short
    t1 = time.perf_counter()
    cpu_pred = cpu_wide(*check)
    cpu_s = time.perf_counter() - t1
    cpu_err = max((card_pred.surface.cpu() - cpu_pred.surface).abs().max().item(),
                  (card_pred.pressure.cpu() - cpu_pred.pressure).abs().max().item())
    print(f"[cpu] wide WeatherMesh at {check_h} x {check_w} (latent [14, {check_h // 4}, "
          f"{check_w // 4}]), {WM_WIDE_CHECK_LAYERS} processor layers: max_abs_diff {cpu_err:.3e} "
          f"(limit {CPU_TOL}) | card K6 launches {short_k6} | cpu forward {cpu_s:.2f} s | phase "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    if not (cpu_err <= CPU_TOL):
        raise AssertionError(f"wide WeatherMesh card vs CPU: {cpu_err} > {CPU_TOL}")
    del cpu_wide, cpu_pred, card_pred

    # 41. K6 with lse and K6b against their plain versions: phase 37's cases
    # a, b, d, e and f, and (g) case a without rpb
    t0 = time.perf_counter()
    k6b_cases = {n: k6_cases[n] for n in "abdef"}
    k6b_cases["g"] = {**k6_cases["a"], "bias": False}
    k6b = {n: k6b_case(natten3d, natten_flash, neighborhood_attention_3d_reference, _window_indices,
                       n, gen, **c) for n, c in k6b_cases.items()}
    k6b_bound, k6b_bound_by = bound(k6b["a"]["flops"], k6b["a"]["nbytes"])
    k6b_split_bound = {kind: bound(k6b["a"]["flops_split"][kind], k6b["a"]["nbytes_split"][kind])
                       for kind in ("dq", "dkv")}
    print(f"[k6b] per train step ({K6_PER_FORWARD} x case a): backward_ms="
          f"{K6_PER_FORWARD * k6b['a']['ms']:.4f} (dq {K6_PER_FORWARD * k6b['a']['split']['dq']:.4f}, "
          f"bound {K6_PER_FORWARD * k6b_split_bound['dq'][0]:.4f} {k6b_split_bound['dq'][1]}; dk/dv "
          f"{K6_PER_FORWARD * k6b['a']['split']['dkv']:.4f}, bound "
          f"{K6_PER_FORWARD * k6b_split_bound['dkv'][0]:.4f} {k6b_split_bound['dkv'][1]}) "
          f"plain_ms={K6_PER_FORWARD * k6b['a']['plain_ms']:.4f} "
          f"sdpa_bwd_ms={K6_PER_FORWARD * k6b['a']['library_ms']:.4f} bound_ms="
          f"{K6_PER_FORWARD * k6b_bound:.4f} ({k6b_bound_by}: {k6b['a']['pairs'] / 1e6:.1f} M pairs, "
          f"{k6b['a']['flops'] / 1e9:.2f} GFLOP, {k6b['a']['nbytes'] / 1e6:.1f} MB per layer; the "
          f"slot table {k6b['a']['table'] / 1e6:.1f} MB a layer, written by dq and read by dk/dv) | K6 "
          f"{K6_PER_FORWARD * k6b['a']['fwd_ms']:.4f}, with lse {K6_PER_FORWARD * k6b['a']['lse_ms']:.4f} "
          f"| phase {time.perf_counter() - t0:.1f} s", flush=True)

    # 42. wm_wide_train: 3 steps of make_train_step on the 768-d WeatherMesh
    # (phase 38's weights) with phase 23's objective and optimiser
    t0 = time.perf_counter()
    wide_targets = tuple(torch.randn(t.shape, generator=wm_gen).to("cuda") for t in (surface, pressure))

    def wide_counts():
        return (natten3d.LAUNCHES, natten3d.BWD_DQ_LAUNCHES, natten3d.BWD_DKV_LAUNCHES,
                natten_flash.LAUNCHES, natten_flash.BWD_DQ_LAUNCHES, natten_flash.BWD_DKV_LAUNCHES)

    before_params = [t.detach().clone() for t in wide.module.parameters()]
    torch.cuda.reset_peak_memory_stats()
    natten3d.LAUNCHES = natten3d.BWD_DQ_LAUNCHES = natten3d.BWD_DKV_LAUNCHES = 0
    natten_flash.LAUNCHES = natten_flash.BWD_DQ_LAUNCHES = natten_flash.BWD_DKV_LAUNCHES = 0
    wide_step = port.make_train_step(
        wide.module.parameters(), wide.forward_fn(), wm_objective, port.make_optimizer(1e-4)
    )
    wide_train_ms, wide_losses = [], []
    for _ in range(3):
        before = wide_counts()
        loss, ms = timed(lambda: wide_step(surface, pressure, wide_targets))
        made = tuple(a - b for a, b in zip(wide_counts(), before))
        if made != (K6_PER_FORWARD,) * 3 + (0,) * 3:
            raise AssertionError(f"a wide train step made {made} (K6, K6b dq, K6b dk/dv, K5a, K5b dq, "
                                 "K5b dk/dv) launches, expected 16 of each K6 kernel and no K5")
        if not torch.isfinite(loss):
            raise AssertionError(f"wide WeatherMesh train loss {loss.item()}")
        wide_train_ms.append(ms)
        wide_losses.append(loss.item())
    wide_train_launches = wide_counts()[:3]
    wide_train_peak = torch.cuda.max_memory_allocated() / 2**30
    names = [n for n, _ in wide.module.named_parameters()]
    unchanged = [n for n, a, b in zip(names, before_params, wide.module.parameters())
                 if torch.equal(a, b)]
    if unchanged:
        raise AssertionError(f"wide parameters unchanged after 3 train steps: {unchanged}")
    print(f"[wm_wide_train] 3 steps | step_ms {[round(t, 3) for t in wide_train_ms]} | steady median "
          f"{statistics.median(wide_train_ms[1:]):.3f} | loss {[round(v, 6) for v in wide_losses]} | "
          f"launches per step K6 (with lse) 16, K6b dq 16, dk/dv 16, K5a/K5b 0 | all {len(names)} "
          f"parameter tensors changed (rpb included) | peak GiB {wide_train_peak:.2f} | phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    profile_request(lambda: wide_step(surface, pressure, wide_targets), "wide WeatherMesh train step")
    del wide_step, before_params, wide_targets

    # 43. the same weights and one batch at 28 x 60 (latent [14, 7, 15]; at 3
    # deg the CPU's forward and backward would take ~4 min), forward and
    # backward on the card and on the CPU
    t0 = time.perf_counter()
    check_h, check_w = WM_WIDE_GRAD_GRID
    check = [torch.randn(1, check_h, check_w, 8, generator=wm_gen),
             torch.randn(1, levels, check_h, check_w, 4, generator=wm_gen)]
    check_targets = tuple(torch.randn(t.shape, generator=wm_gen) for t in check)

    def wide_card_loss():
        return wm_objective(wide.forward_fn()(*(t.cuda() for t in check)),
                            tuple(t.cuda() for t in check_targets))

    wide.module.zero_grad(set_to_none=True)
    before = wide_counts()
    card_value = wide_card_loss()
    card_value.backward()
    made = tuple(a - b for a, b in zip(wide_counts(), before))
    if made != (K6_PER_FORWARD,) * 3 + (0,) * 3:
        raise AssertionError(f"the wide check batch made {made} launches, expected 16 of each K6 kernel")
    card_grads = {k: t.grad.cpu() for k, t in wide.module.named_parameters()}
    repeat = card_repeat(wide.module, wide_card_loss, card_value.item(), card_grads, required=True)
    # Card against CPU at WM_WIDE_CHECK_LAYERS processor layers (the trained weights).
    short = shallow_weathermesh(port, WM_WIDE, wide.module, "cuda")
    short.module.zero_grad(set_to_none=True)
    card_value = wm_objective(short.forward_fn()(*(t.cuda() for t in check)),
                              tuple(t.cuda() for t in check_targets))
    card_value.backward()
    card_grads = {k: t.grad.cpu() for k, t in short.module.named_parameters()}
    cpu_wide = shallow_weathermesh(port, WM_WIDE, short.module, "cpu")
    del short
    t1 = time.perf_counter()
    cpu_value = wm_objective(cpu_wide.forward_fn()(*check), check_targets)
    cpu_value.backward()
    cpu_s = time.perf_counter() - t1
    cpu_grads = {k: t.grad for k, t in cpu_wide.module.named_parameters()}
    loss_rel = abs(card_value.item() - cpu_value.item()) / abs(cpu_value.item())
    worst, worst_name = grads_close(card_grads, cpu_grads)
    print(f"[cpu] wide WeatherMesh at {check_h} x {check_w} (latent [14, {check_h // 4}, "
          f"{check_w // 4}]), {WM_WIDE_CHECK_LAYERS} processor layers: train loss card "
          f"{card_value.item():.6f} cpu {cpu_value.item():.6f} rel "
          f"{loss_rel:.3e} (limit {LOSS_RTOL}) | gradients: worst error / limit {worst:.3e} "
          f"({worst_name}) over {len(cpu_grads)} tensors | cpu forward+backward {cpu_s:.2f} s | "
          f"{repeat} | phase {time.perf_counter() - t0:.1f} s", flush=True)
    if not (loss_rel <= LOSS_RTOL):
        raise AssertionError(f"wide WeatherMesh train loss card vs CPU: {loss_rel} > {LOSS_RTOL}")
    if not (worst <= 1.0):
        raise AssertionError(f"wide WeatherMesh gradient of {worst_name} card vs CPU: {worst} x its limit")
    del cpu_wide, wide, surfaces, pressures, card_grads, cpu_grads
    torch.cuda.empty_cache()

    # 44-47: GenCast's bf16 policy
    bf16 = gencast_bf16_phases(port, clustered_flash, _build, gen, dict(
        weights9=weights9, requests9=requests9, out9=clustered_out, denoise_ms=denoise_ms,
        sample_ms=sample_ms[-1], train_ms=statistics.median(train_ms[1:]), weights16=weights16,
        grads16=grads16, batch16=batch16, objective16=objective16, loss16=card_value16,
    ))
    del weights9, weights16, grads16, batch16

    # 48-50: the forecaster's bf16 policy
    fc16 = forecaster_bf16_phases(port, fused_mlp, edge_mlp, segment_sums, _build, gen, dict(
        lat_lons=lat_lons, bundles=dict(g2m=g2m, latent=latent, m2g=m2g), inputs=inputs,
        request_ms=request_ms, request_kernels=request_kernels, batch=(fc_x, fc_y),
        train_ms=statistics.median(fc_ms[1:]), step_kernels=step_kernels,
    ))

    # 51-55: WeatherMesh's bf16 policy
    wm16 = weathermesh_bf16_phases(port, natten_flash, natten3d, _window_indices, _build, gen, dict(
        wm_ms=wm_ms, wm_train_ms=statistics.median(wm_train_ms[1:]), wide_ms=wide_ms,
        wide_train_ms=statistics.median(wide_train_ms[1:]),
    ))
    k5_16, k6_16 = wm16["k5"], wm16["k6"]

    # 56-61: FGN at bench.py's scale, f32 and bf16
    fgn = fgn_phases(port, clustered_flash, segment_sums, _build, gen)
    fgn_k3, fgn_s32 = fgn["k3"], fgn["s32"]
    f32, bf16_ = torch.float32, torch.bfloat16

    def fgn_wide(dtype, field, key):  # per c = 768 launch: one a member forward or step
        return fgn_k3[(768, dtype)][field][key]

    kernels = [
        {
            "name": "fused_edge_mlp",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/edge_mlp.cu",
            "replaces": "graph_weather_tpu/ops/pallas/edge_mlp.py:84",
            "launches": serve_k1_launches,  # raw mode: off the main path, whose edge updates run K2
            "launches_phase3": k1_launches_phase3,
            "max_abs_err": max(v[0] for v in k1.values()),
            "ms": k1_ms,  # per forward: g2m + 9 latent + m2g
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound_ms,
            "bound_by": k1_bound_by,
            "bound_tf32x3_ms": per_forward({n: tf32x3_ms(v[3]) for n, v in k1.items()}),
            "library_ms": None,  # no single PyTorch call computes the fused edge MLP
        },
        {
            "name": "fused_edge_update",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/edge_mlp.cu",
            "replaces": "graph_weather_tpu/ops/pallas/fused_mlp.py:75",
            "launches": serve_launches,  # 3 requests
            "max_abs_err": max(v[0] for v in k2.values()),
            "ms": k2_ms,  # per forward: g2m + 9 latent + m2g
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound_ms,
            "bound_by": k2_bound_by,
            "bound_tf32x3_ms": per_forward({n: tf32x3_ms(v[3]) for n, v in k2.items()}),
            "library_ms": None,  # no single PyTorch call computes the fused edge update
            "train_launches": fc_launches[0],  # 3 train steps
        },
        {
            "name": "fused_edge_update_backward",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/fused_mlp_bwd.cu",
            # No Pallas backward exists: XLA differentiates the JAX EdgeBlock,
            # whose forward K2 replaces.
            "replaces": "graph_weather_tpu/nn/graph_blocks.py:160",
            "launches": fc_launches[1],  # 3 train steps
            "max_abs_err": max(v["err"] for v in k2b.values()),  # of each gradient's max|g|
            "ms": k2b_ms["kernel"],  # per train step: g2m + 9 latent + m2g
            "backward_ms": k2b_ms["backward"],  # with the weight products and node sums
            "plain_ms": k2b_ms["plain"],
            "bound_ms": k2b_bound_ms,
            "bound_by": k2b_bound_by,
            "bound_tf32x3_ms": per_forward({n: tf32x3_ms(v["flops"]) for n, v in k2b.items()}),
            "library_ms": None,  # no single PyTorch call computes the edge update's gradient
        },
        {
            "name": "clustered_flash_attention",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:427",
            "launches": denoise_launches,
            "max_abs_err": max(v[0] for v in k3a.values()),
            "ms": k3a_ms,
            "plain_ms": k3a_plain_ms,
            "bound_ms": k3a_bound_ms,
            "bound_by": k3a_bound_by,
            "bound_tf32x3_ms": per_eval_sum({c: tf32x3_ms(v[4]) for c, v in k3a.items()}),
            "library_ms": k3a_sdpa_ms,
            "sdpa_ms": k3a_sdpa_ms,
            "train_launches": train_launches[0],  # 3 train steps, with lse
        },
        {
            "name": "clustered_flash_backward_general",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:560",
            "launches": train_launches[3],  # the k-hop graph is symmetric: K3c, not K3b
            "launches_phase14": k3b_phase14,  # counted over the checked call at each width
            "max_abs_err": max(max(v["errs"]["k3b"], v["errs"]["k3b_vs_k3c"]) for v in bwd.values()),
            "ms": k3b_ms,
            "plain_ms": k3b_plain_ms,
            "bound_ms": bwd_bound_ms,
            "bound_by": bwd_bound_by,
            "bound_tf32x3_ms": per_eval_sum({c: tf32x3_ms(v["flops"]) for c, v in bwd.items()}),
            "library_ms": bwd_sdpa_ms,
        },
        {
            "name": "clustered_flash_backward_symmetric",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:749",
            "launches": train_launches[1],  # dq kernel; as many of the dk/dv kernel
            "launches_dkv": train_launches[2],
            "max_abs_err": max(v["errs"]["k3c"] for v in bwd.values()),
            "ms": k3c_ms,
            "plain_ms": k3c_plain_ms,
            "bound_ms": bwd_bound_ms,
            "bound_by": bwd_bound_by,
            "bound_tf32x3_ms": per_eval_sum({c: tf32x3_ms(v["flops"]) for c, v in bwd.items()}),
            "library_ms": bwd_sdpa_ms,
        },
        {
            "name": "clustered_flash_attention_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:427",
            "launches": bf16["serve16_launches"],  # phase 45's 3 bf16 requests
            "max_abs_err": max(v["errs"]["k3a"][0] for v in bf16["k3_16"].values()),
            "err_over_limit": max(v["errs"]["k3a"][1] for v in bf16["k3_16"].values()),  # of 2^-6 max|plain|
            "ms": bf16["per_eval16"]("k3a", "ms"),  # per denoiser eval
            "with_lse_ms": bf16["per_eval16"]("k3a_lse", "ms"),
            "f32_ms": bf16["per_eval16"]("k3a", "f32_ms"),  # the f32 kernel on the same values
            "plain_ms": bf16["per_eval16"]("k3a", "plain_ms"),
            "bound_ms": bf16["k3a16_bound"],
            "bound_by": bf16["k3a16_by"],
            "library_ms": bf16["k3a16_sdpa"],  # SDPA in bf16
            "train_launches": bf16["train16_launches"][4],  # phase 47's 3 bf16 train steps, with lse
        },
        {
            "name": "clustered_flash_backward_general_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:560",
            "launches": bf16["train16_launches"][7],  # the k-hop graph is symmetric: K3c, not K3b
            "launches_phase44": bf16["k3b16_phase44"],  # the checked call at each width, before the timings
            "max_abs_err": max(v["errs"]["k3b"][0] for v in bf16["k3_16"].values()),
            "err_over_limit": max(v["errs"]["k3b"][1] for v in bf16["k3_16"].values()),
            "ms": bf16["per_eval16"]("k3b", "ms"),  # per train step
            "f32_ms": bf16["per_eval16"]("k3b", "f32_ms"),
            "plain_ms": bf16["per_eval16"]("k3b", "plain_ms"),
            "bound_ms": bf16["bwd16_bound"],
            "bound_by": bf16["bwd16_by"],
            "library_ms": bf16["bwd16_sdpa"],  # SDPA's backward in bf16
        },
        {
            "name": "clustered_flash_backward_symmetric_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:749",
            "launches": bf16["train16_launches"][5],  # dq kernel, phase 47; as many of the dk/dv kernel
            "launches_dkv": bf16["train16_launches"][6],
            "max_abs_err": max(v["errs"]["k3c"][0] for v in bf16["k3_16"].values()),
            "err_over_limit": max(v["errs"]["k3c"][1] for v in bf16["k3_16"].values()),
            "ms": bf16["per_eval16"]("k3c", "ms"),  # per train step
            "f32_ms": bf16["per_eval16"]("k3c", "f32_ms"),
            "plain_ms": bf16["per_eval16"]("k3c", "plain_ms"),
            "bound_ms": bf16["bwd16_bound"],
            "bound_by": bf16["bwd16_by"],
            "library_ms": bf16["bwd16_sdpa"],
        },
        {
            "name": "fused_edge_update_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/edge_mlp.cu",
            "replaces": "graph_weather_tpu/ops/pallas/fused_mlp.py:75",
            "launches": fc16["serve16_launches"][1],  # phase 49's 3 bf16 requests
            "max_abs_err": fc16["k2"]["err"],
            "err_over_limit": fc16["k2"]["ratio"],  # of 2^-6 max|plain|
            "ms": fc16["k2"]["ms"],  # per forward: g2m + 9 latent + m2g
            "f32_ms": fc16["k2"]["f32_ms"],  # the f32 kernel on the same values
            "plain_ms": fc16["k2"]["plain_ms"],
            "bound_ms": fc16["k2"]["bound_ms"],
            "bound_by": fc16["k2"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the fused edge update
            "train_launches": fc16["train16_launches"][1],  # phase 50's 3 bf16 train steps
        },
        {
            "name": "fused_edge_update_backward_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/fused_mlp_bwd.cu",
            # No Pallas backward exists: XLA differentiates the JAX EdgeBlock.
            "replaces": "graph_weather_tpu/nn/graph_blocks.py:160",
            "launches": fc16["train16_launches"][3],  # phase 50's 3 bf16 train steps
            "max_abs_err": fc16["k2b"]["err"],
            "err_over_limit": fc16["k2b"]["ratio"],
            "ms": fc16["k2b"]["ms"],  # per train step
            "backward_ms": fc16["k2b"]["backward_ms"],  # with the weight products and S
            "f32_ms": fc16["k2b"]["f32_ms"],
            "plain_ms": fc16["k2b"]["plain_ms"],
            "bound_ms": fc16["k2b"]["bound_ms"],
            "bound_by": fc16["k2b"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes the edge update's gradient
        },
        {
            "name": "segment_sum_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/segment_sum.cu",
            # No Pallas kernel: XLA's bf16 segment_sum, and the gradient of
            # jnp.take in the EdgeBlock (a scatter-add in edge order).
            "replaces": "graph_weather_tpu/ops/scatter.py:35",
            "also_replaces": "graph_weather_tpu/nn/graph_blocks.py:248",
            "launches": fc16["train16_launches"][5],  # phase 50's 3 bf16 train steps
            "serve_launches": fc16["serve16_launches"][5],  # phase 49's 3 bf16 requests
            "max_abs_err": fc16["s"]["err"],  # bit-equal to its plain version
            "ms": fc16["s"]["ms"],  # per train step: its 22 sums
            "request_ms": fc16["s"]["request_ms"],  # per request: the g2m aggregation
            "plain_ms": fc16["s"]["plain_ms"],
            "bound_ms": fc16["s"]["bound_ms"],
            "bound_by": fc16["s"]["bound_by"],
            "library_ms": fc16["s"]["library_ms"],  # index_add_ in bf16 (atomics: another rounding)
        },
        {
            "name": "natten_flash_forward",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/natten_flash.py:435",
            "launches": wm_launches,  # 3 requests
            "max_abs_err": max(v["err"] for v in k5a.values()),
            "ms": K5_PER_FORWARD * k5a["a"]["ms"],  # per forward: 8 layers of case a
            "plain_ms": K5_PER_FORWARD * k5a["a"]["plain_ms"],
            "bound_ms": K5_PER_FORWARD * k5a_bound,
            "bound_by": k5a_bound_by,
            "library_ms": K5_PER_FORWARD * k5a["a"]["sdpa_ms"],
            "train_launches": wm_train_launches[0],  # 3 train steps, with lse
            # per launch: case a (the model's layers) and c ((5, 7, 7), 8 x 32)
            "case_a_ms": k5a["a"]["ms"],
            "case_a_library_ms": k5a["a"]["sdpa_ms"],
            "case_c_ms": k5a["c"]["ms"],
            "case_c_library_ms": k5a["c"]["sdpa_ms"],
        },
        {
            "name": "natten_flash_backward_dq",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/natten_flash.py:655",
            "launches": wm_train_launches[1],  # 3 train steps
            "max_abs_err": max(max(v["errs"]["dq"], v["errs"]["drpb_rel"]) for v in k5b.values()),
            "ms": K5_PER_FORWARD * k5b["a"]["split"]["dq"],  # per train step: 8 layers of case a
            "backward_ms": K5_PER_FORWARD * k5b["a"]["ms"],  # both kernels, delta, drpb sum
            "plain_ms": K5_PER_FORWARD * k5b["a"]["plain_ms"],  # the whole plain backward
            "bound_ms": K5_PER_FORWARD * k5b_split_bound["dq"][0],
            "bound_by": k5b_split_bound["dq"][1],
            "library_ms": K5_PER_FORWARD * k5b["a"]["sdpa_ms"],  # SDPA's whole backward
        },
        {
            "name": "natten_flash_backward_dkv",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/natten_flash.py:655",
            "launches": wm_train_launches[2],  # 3 train steps
            "max_abs_err": max(max(v["errs"]["dk"], v["errs"]["dv"]) for v in k5b.values()),
            "ms": K5_PER_FORWARD * k5b["a"]["split"]["dkv"],  # per train step: 8 layers of case a
            "plain_ms": K5_PER_FORWARD * k5b["a"]["plain_ms"],  # the whole plain backward
            "bound_ms": K5_PER_FORWARD * k5b_split_bound["dkv"][0],
            "bound_by": k5b_split_bound["dkv"][1],
            "library_ms": K5_PER_FORWARD * k5b["a"]["sdpa_ms"],  # SDPA's whole backward
        },
        {
            "name": "natten3d_slot_forward",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten3d.cu",
            "replaces": "graph_weather_tpu/ops/pallas/natten3d.py:294",
            "launches": wide_launches,  # 3 wide requests
            "max_abs_err": max(v["err"] for v in k6.values()),
            "ms": K6_PER_FORWARD * k6["a"]["ms"],  # per request: 16 layers of case a
            "plain_ms": K6_PER_FORWARD * k6["a"]["plain_ms"],
            "bound_ms": K6_PER_FORWARD * k6_bound,
            "bound_by": k6_bound_by,
            "library_ms": K6_PER_FORWARD * k6["a"]["library_ms"],
            "lse_ms": K6_PER_FORWARD * k6b["a"]["lse_ms"],  # per train step, with lse (phase 41)
            "train_launches": wide_train_launches[0],  # 3 wide train steps, with lse
        },
        {
            "name": "natten3d_backward",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten3d_bwd.cu",
            # No Pallas backward exists: _natten_bwd differentiates the XLA
            # slot scan (the custom_vjp of K6).
            "replaces": "graph_weather_tpu/ops/pallas/natten3d.py:455",
            "launches": wide_train_launches[1],  # dq kernel, 3 wide train steps
            "launches_dkv": wide_train_launches[2],
            "max_abs_err": max(max(v["errs"].values()) for v in k6b.values()),  # of each max|g|
            "ms": K6_PER_FORWARD * (k6b["a"]["split"]["dq"] + k6b["a"]["split"]["dkv"]),
            "dq_ms": K6_PER_FORWARD * k6b["a"]["split"]["dq"],  # per train step: 16 x case a
            "dkv_ms": K6_PER_FORWARD * k6b["a"]["split"]["dkv"],
            "backward_ms": K6_PER_FORWARD * k6b["a"]["ms"],  # both kernels, delta, drpb sum
            "dq_bound_ms": K6_PER_FORWARD * k6b_split_bound["dq"][0],
            "dkv_bound_ms": K6_PER_FORWARD * k6b_split_bound["dkv"][0],
            "table_bytes": k6b["a"]["table"],  # the slot table of one case-a layer
            "plain_ms": K6_PER_FORWARD * k6b["a"]["plain_ms"],
            "bound_ms": K6_PER_FORWARD * k6b_bound,
            "bound_by": k6b_bound_by,
            "library_ms": K6_PER_FORWARD * k6b["a"]["library_ms"],  # SDPA's backward, windows
        },
        {
            "name": "banded_flash_attention",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/banded_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/banded_flash.py:213",
            "launches": band_launches,  # 3 requests
            "max_abs_err": max(v["err"] for v in k4a.values()),
            "ms": k4a_ms,  # per evaluation: 15 x c = 128 + c = 512
            "plain_ms": k4a_plain_ms,
            "bound_ms": k4a_bound_ms,
            "bound_by": k4a_bound_by,
            "bound_tf32x3_ms": k4a_tf32x3,
            "library_ms": k4a_sdpa_ms,
            "train_launches": band_train_launches[0],  # 3 train steps, with lse
        },
        {
            "name": "banded_flash_backward_dq",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/banded_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/banded_flash.py:429",
            "launches": band_train_launches[1],  # 3 train steps
            "max_abs_err": max(v["errs"]["dq"] for v in k4b.values()),
            "ms": k4b_ms["dq"],  # per train step
            "plain_ms": k4b_plain_ms,  # the whole plain backward (dq, dk, dv)
            "bound_ms": k4b_bound["dq"][0],
            "bound_by": k4b_bound["dq"][1],
            "bound_tf32x3_ms": k4b_tf32x3["dq"],
            "library_ms": k4b_sdpa_ms,  # SDPA's whole backward
        },
        {
            "name": "banded_flash_backward_dkv",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/banded_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/banded_flash.py:487",
            "launches": band_train_launches[2],  # 3 train steps, symmetric role
            "max_abs_err": max(max(v["errs"]["dk"], v["errs"]["dv"], v["errs"]["padded"])
                               for v in k4b.values()),
            "ms": k4b_ms["dkv"],  # per train step, symmetric role
            "plain_ms": k4b_plain_ms,  # the whole plain backward (dq, dk, dv)
            "bound_ms": k4b_bound["dkv"][0],
            "bound_by": k4b_bound["dkv"][1],
            "bound_tf32x3_ms": k4b_tf32x3["dkv"],
            "library_ms": k4b_sdpa_ms,  # SDPA's whole backward
        },
        {
            "name": "banded_flash_backward_dkv_general",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/banded_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/banded_flash.py:487",
            "launches": band_train_launches[3],  # the k-hop graph is symmetric: none
            "launches_phase27": k4b_general_phase27,  # its checks and timings on the real layout
            "max_abs_err": max(k4b_directed_err, max(v["errs"]["general"] for v in k4b.values())),
            "ms": k4b_ms["dkv_general"],  # per train step, on the real layout
            "plain_ms": k4b_plain_ms,
            "bound_ms": k4b_bound["dkv"][0],
            "bound_by": k4b_bound["dkv"][1],
            "bound_tf32x3_ms": k4b_tf32x3["dkv"],
            "library_ms": k4b_sdpa_ms,
        },
        {
            "name": "natten_flash_forward_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/natten_flash.py:435",
            "launches": wm16["wm"]["serve_launches"][3],  # phase 52's 3 bf16 requests
            "max_abs_err": k5_16["errs"]["out"][0],
            "err_over_limit": k5_16["errs"]["out"][1],  # of 2^-6 max|plain|
            "ms": K5_PER_FORWARD * k5_16["ms"]["k5a"],  # per request: 8 layers of case a
            "f32_ms": K5_PER_FORWARD * k5_16["ms"]["k5a_f32"],  # the f32 kernel on the same values
            "plain_ms": K5_PER_FORWARD * k5_16["ms"]["k5a_plain"],
            "bound_ms": K5_PER_FORWARD * wm16["k5a_bound"][0],
            "bound_by": wm16["k5a_bound"][1],
            "library_ms": K5_PER_FORWARD * k5_16["ms"]["sdpa"],  # SDPA in bf16 on the halo tiles
            "train_launches": wm16["wm"]["train_launches"][3],  # phase 53's 3 steps, with lse
        },
        {
            "name": "natten_flash_backward_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/natten_flash.py:655",
            "launches": wm16["wm"]["train_launches"][4],  # dq kernel, phase 53's 3 steps
            "launches_dkv": wm16["wm"]["train_launches"][5],
            "max_abs_err": max(k5_16["errs"][n][0] for n in ("dq", "dk", "dv", "drpb")),
            "err_over_limit": max(k5_16["errs"][n][1] for n in ("dq", "dk", "dv", "drpb")),
            "ms": K5_PER_FORWARD * k5_16["ms"]["k5b"],  # per train step: both kernels, delta, drpb sum
            "dq_ms": K5_PER_FORWARD * k5_16["ms"]["dq"],
            "dkv_ms": K5_PER_FORWARD * k5_16["ms"]["dkv"],
            "dq_bound_ms": K5_PER_FORWARD * wm16["k5b_dq_bound"][0],
            "dkv_bound_ms": K5_PER_FORWARD * wm16["k5b_dkv_bound"][0],
            "f32_ms": K5_PER_FORWARD * k5_16["ms"]["k5b_f32"],
            "plain_ms": K5_PER_FORWARD * k5_16["ms"]["k5b_plain"],
            "bound_ms": K5_PER_FORWARD * wm16["k5b_bound"][0],
            "bound_by": wm16["k5b_bound"][1],
            "library_ms": K5_PER_FORWARD * k5_16["ms"]["sdpa_bwd"],  # SDPA's backward in bf16
        },
        {
            "name": "natten3d_slot_forward_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten3d.cu",
            "replaces": "graph_weather_tpu/ops/pallas/natten3d.py:294",
            "launches": wm16["wide"]["serve_launches"][9],  # phase 54's 3 bf16 requests
            "max_abs_err": k6_16["errs"]["out"][0],
            "err_over_limit": max(wm16["k6_errs"].values()),  # every output and gradient, cases a, b
            "ms": K6_PER_FORWARD * k6_16["ms"]["k6"],  # per request: 16 layers of case a
            "f32_ms": K6_PER_FORWARD * k6_16["ms"]["k6_f32"],
            "plain_ms": K6_PER_FORWARD * k6_16["ms"]["k6_plain"],
            "bound_ms": K6_PER_FORWARD * wm16["k6_bound"][0],
            "bound_by": wm16["k6_bound"][1],
            "library_ms": K6_PER_FORWARD * k6_16["ms"]["sdpa"],  # SDPA in bf16, gathered windows
            "train_launches": wm16["wide"]["train_launches"][9],  # phase 55's 3 steps, with lse
        },
        {
            "name": "natten3d_backward_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/natten3d_bwd.cu",
            # No Pallas backward exists: _natten_bwd differentiates the XLA
            # slot scan (the custom_vjp of K6), whose bf16 roundings this mirrors.
            "replaces": "graph_weather_tpu/ops/pallas/natten3d.py:455",
            "launches": wm16["wide"]["train_launches"][10],  # dq kernel, phase 55's 3 steps
            "launches_dkv": wm16["wide"]["train_launches"][11],
            "launches_drpb": wm16["wide"]["train_launches"][12:14],  # the two drpb kernels
            "max_abs_err": max(k6_16["errs"][n][0] for n in ("dq", "dk", "dv", "drpb")),
            "err_over_limit": max(k6_16["errs"][n][1] for n in ("dq", "dk", "dv", "drpb")),
            "ms": K6_PER_FORWARD * (k6_16["ms"]["dq"] + k6_16["ms"]["dkv"] + k6_16["ms"]["drpb_slots"]
                                    + k6_16["ms"]["drpb"]),  # per train step: 16 x case a
            "dq_ms": K6_PER_FORWARD * k6_16["ms"]["dq"],
            "dkv_ms": K6_PER_FORWARD * k6_16["ms"]["dkv"],
            "drpb_ms": K6_PER_FORWARD * (k6_16["ms"]["drpb_slots"] + k6_16["ms"]["drpb"]),
            "backward_ms": K6_PER_FORWARD * k6_16["ms"]["k6b"],  # with the table's allocation
            "dq_bound_ms": K6_PER_FORWARD * wm16["k6b_dq_bound"][0],
            "dkv_bound_ms": K6_PER_FORWARD * wm16["k6b_dkv_bound"][0],
            "f32_ms": K6_PER_FORWARD * k6_16["ms"]["k6b_f32"],
            "plain_ms": K6_PER_FORWARD * k6_16["ms"]["k6b_plain"],  # one run of the plain backward
            "bound_ms": K6_PER_FORWARD * wm16["k6b_bound"][0],
            "bound_by": wm16["k6b_bound"][1],
            "library_ms": K6_PER_FORWARD * k6_16["ms"]["sdpa_bwd"],  # SDPA's backward in bf16, windows
        },
        {
            "name": "clustered_flash_attention_c768",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:427",
            # The W768 tile's own counter over phase 58's 3 f32 FGN member
            # requests (one a request: the last block), and K3a's at all widths
            "launches": fgn["serve"]["f32"]["launches"]["WIDE_LAUNCHES"],
            "launches_all_widths": fgn["serve"]["f32"]["launches"]["LAUNCHES"],
            "max_abs_err": fgn_k3[(768, f32)]["errs"]["k3a"][0],
            "ms": fgn_wide(f32, "ms", "k3a"),  # one launch at c = 768, splits-6 layout
            "with_lse_ms": fgn_wide(f32, "ms", "k3a_lse"),
            # K3a's device time in the profiled member request: all 24, and the c = 768 one
            "member_device_ms": fgn["serve"]["f32"]["k3a_device"][0],
            "member_device_ms_c768": fgn["serve"]["f32"]["k3a_device"][2],
            "plain_ms": fgn_wide(f32, "plain_ms", "k3a"),
            "bound_ms": fgn_k3[(768, f32)]["fwd_bound"][0],
            "bound_by": fgn_k3[(768, f32)]["fwd_bound"][1],
            "library_ms": fgn_k3[(768, f32)]["sdpa_ms"],
            "library_backend": fgn_k3[(768, f32)]["backend"],
            # phase 60's 3 f32 remat steps (2 a step at c = 768)
            "train_launches": fgn["train"]["f32"]["launches"]["WIDE_LAUNCHES"],
        },
        {
            "name": "clustered_flash_backward_symmetric_c768",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:749",
            # the W768 dq kernel's counter over phase 60's 3 f32 steps (one a step)
            "launches": fgn["train"]["f32"]["launches"]["WIDE_SYMMETRIC_DQ_LAUNCHES"],
            "launches_dkv": fgn["train"]["f32"]["launches"]["WIDE_SYMMETRIC_DKV_LAUNCHES"],
            "launches_all_widths": fgn["train"]["f32"]["launches"]["SYMMETRIC_DQ_LAUNCHES"],
            "max_abs_err": fgn_k3[(768, f32)]["errs"]["k3c"][0],
            "ms": fgn_wide(f32, "ms", "k3c"),  # both kernels and delta, one layer at c = 768
            # K3c's device time in the profiled train step: all 48 launches, and the 2 at c = 768
            "step_device_ms": fgn["train"]["f32"]["k3c_device"][0],
            "step_device_ms_c768": fgn["train"]["f32"]["k3c_device"][2],
            "plain_ms": fgn_wide(f32, "plain_ms", "k3c"),
            "bound_ms": fgn_k3[(768, f32)]["bwd_bound"][0],
            "bound_by": fgn_k3[(768, f32)]["bwd_bound"][1],
            "library_ms": fgn_k3[(768, f32)]["sdpa_bwd_ms"],
        },
        {
            "name": "clustered_flash_attention_c768_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:427",
            # The W768 tile's own counter over phase 59's 3 bf16 FGN member
            # requests (one a request: the last block), and K3a's at all widths
            "launches": fgn["serve"]["bf16"]["launches"]["BF16_WIDE_LAUNCHES"],
            "launches_all_widths": fgn["serve"]["bf16"]["launches"]["BF16_LAUNCHES"],
            "max_abs_err": fgn_k3[(768, bf16_)]["errs"]["k3a"][0],
            "err_over_limit": fgn_k3[(768, bf16_)]["errs"]["k3a"][1],  # of 2^-6 max|plain|
            "ms": fgn_wide(bf16_, "ms", "k3a"),  # one launch at c = 768, splits-6 layout
            "with_lse_ms": fgn_wide(bf16_, "ms", "k3a_lse"),
            # K3a's device time in the profiled member request: all 24, and the c = 768 one
            "member_device_ms": fgn["serve"]["bf16"]["k3a_device"][0],
            "member_device_ms_c768": fgn["serve"]["bf16"]["k3a_device"][2],
            "plain_ms": fgn_wide(bf16_, "plain_ms", "k3a"),
            "bound_ms": fgn_k3[(768, bf16_)]["fwd_bound"][0],
            "bound_by": fgn_k3[(768, bf16_)]["fwd_bound"][1],
            "library_ms": fgn_k3[(768, bf16_)]["sdpa_ms"],
            "library_backend": fgn_k3[(768, bf16_)]["backend"],
            # phase 60's 3 bf16 remat steps (2 a step at c = 768)
            "train_launches": fgn["train"]["bf16"]["launches"]["BF16_WIDE_LAUNCHES"],
        },
        {
            "name": "clustered_flash_backward_symmetric_c768_bf16",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/clustered_flash_bwd.cu",
            "replaces": "graph_weather_tpu/ops/pallas/clustered_flash.py:749",
            # the W768 dq kernel's counter over phase 60's 3 bf16 steps (one a step)
            "launches": fgn["train"]["bf16"]["launches"]["BF16_WIDE_SYMMETRIC_DQ_LAUNCHES"],
            "launches_dkv": fgn["train"]["bf16"]["launches"]["BF16_WIDE_SYMMETRIC_DKV_LAUNCHES"],
            "launches_all_widths": fgn["train"]["bf16"]["launches"]["BF16_SYMMETRIC_DQ_LAUNCHES"],
            "max_abs_err": fgn_k3[(768, bf16_)]["errs"]["k3c"][0],
            "err_over_limit": fgn_k3[(768, bf16_)]["errs"]["k3c"][1],
            "ms": fgn_wide(bf16_, "ms", "k3c"),  # both kernels and delta, one layer at c = 768
            # K3c's device time in the profiled train step: all 48 launches, and the 2 at c = 768
            "step_device_ms": fgn["train"]["bf16"]["k3c_device"][0],
            "step_device_ms_c768": fgn["train"]["bf16"]["k3c_device"][2],
            "plain_ms": fgn_wide(bf16_, "plain_ms", "k3c"),
            "bound_ms": fgn_k3[(768, bf16_)]["bwd_bound"][0],
            "bound_by": fgn_k3[(768, bf16_)]["bwd_bound"][1],
            "library_ms": fgn_k3[(768, bf16_)]["sdpa_bwd_ms"],
        },
        {
            "name": "segment_sum_f32",
            "route": "cuda",
            "source": "graph_weather_tpu_torch/csrc/segment_sum.cu",
            # No Pallas kernel: XLA's f32 segment_sum and the gradient of
            # jnp.take on the GenCast family's graphs, in edge order.
            "replaces": "graph_weather_tpu/ops/scatter.py:35",
            "also_replaces": "graph_weather_tpu/nn/graph_blocks.py:248",
            "launches": fgn["serve"]["f32"]["launches"]["S_F32"],  # phase 58's 3 f32 member requests
            "train_launches": fgn["train"]["f32"]["launches"]["S_F32"],  # phase 60's 3 f32 steps
            "gencast_launches": gencast_s32_launches,  # phase 9's 3 requests
            "max_abs_err": max(v["err"] for v in fgn_s32.values()),  # against index_add_; plain: bit-equal
            "ms": fgn_s32["g2m receivers"]["ms"],  # FGN's g2m aggregation at 768 columns
            "gather_grad_ms": fgn_s32["m2g senders"]["ms"],
            "plain_ms": fgn_s32["g2m receivers"]["plain_ms"],
            "bound_ms": fgn_s32["g2m receivers"]["bound"][0],
            "bound_by": fgn_s32["g2m receivers"]["bound"][1],
            "library_ms": fgn_s32["g2m receivers"]["library_ms"],  # index_add_ (atomics)
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)  # nvidia-smi's "name, power.limit", as it printed them
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
