"""Drive the PyTorch port's render and training paths once on one NVIDIA
GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels of fsnerf_tpu_torch/csrc with nvcc (one process per
     source, in parallel); then the SiNeRF main path's calls at width 256
     under torch.profiler, before any long run (`siren_routes`): the SIREN
     forward with and without acts, the SIREN march, five SiNeRF train
     steps, a held-out eval and a hierarchical frame must launch the
     warp-specialized SIREN forward, march and backward row pass (the
     routes phases 10-13 take);
 2b. the same at NeRF 8 x 192, 8 x 200 (packed at 256: a NeRF module's
     width is laid out at the next of the kernels' widths 64, 128, 192,
     256, 384, 512 or a multiple of 256 from 768 up with zero units,
     ops/kernels/render.py::nerf_kernel_width), 8 x 512 (the column-split
     kernels), 8 x 700, 8 x 1024 and 8 x 2048 (the streamed ones): 20
     train steps of the occgrid slice and a held-out view must launch
     mlp_train_fwd_kernel, nerf_density_kernel and nerf_march_kernel at
     the packed width (from 768 up their _stream instances) and kernel 6's
     row and dW passes, and call no NeRF module (a forward hook counts its
     calls); then SiNeRF 8 x 512 (the column-split SIREN kernels) and 8 x
     1024 (the streamed ones): its 20 steps and held-out view must launch
     siren_fwd_ws_kernel, siren_bwd_rows_ws_kernel and siren_march_kernel
     at 512 (at 1024 their _stream instances) and call the module only for
     the grid refresh's densities (there is no SIREN density kernel);
  3. ray-march kernel vs its plain PyTorch version at full width — NeRF
     8x256 with seeded weights, the 16,384 rays of a 128x128 held-out
     SphereScene view, a res-128 grid rebuilt from the model's densities,
     compaction to the eval K and the depth-coherence sort — in a normal
     case and in a case whose raised sigma bias saturates rays so blocks
     exit early: rgb and opacity within 7e-3, depth within 3e-2, equal
     executed-step counts; the kernel's ptxas registers and spills, its
     early-exit time and the wrapper's host ms per call;
  4. the render slice: render_path over 3 path poses at 128x128 through
     make_fused_render_fn, derive_eval_n_compact and render_frame, with the
     ray-march launch count read around that run;
  5. train kernels vs their plain versions at full width (8x256, 1024 rays
     x K 192 = 196,608 rows, the cotangent of an MSE loss): rgb within
     1e-3, sigma within 1e-2 of max |sigma|, every weight and bias gradient
     within 1e-2 of its max |plain gradient|, two kernel runs bitwise equal
     (the forward's out and acts, the backward's gradients),
     saved-activations and recompute backwards bitwise equal; CUDA-event
     times of both, kernel and plain, the forward's host ms per call and
     bound share, the recompute-mode backward's time, and the backward's
     three launches (row pass, weight-gradient pass, reduce) from
     torch.profiler's kernel events;
  6. the training slice: train() from seeded weights on an 8-view 128x128
     SphereScene with the default sampling, then the held-out views through
     the ray march on the trained grid, with the three kernels' launch
     counts read around that run; the loss must fall and the held-out PSNR
     must rise at least 5 dB above the untrained weights'; the trained
     weights' eval K and ray-march skip fraction are printed. Like every
     training slice here, train() runs each step as a replay of the CUDA
     graph of its kind (train/step.py::make_train_chunk); the rungs of the
     compaction ladder, their graphs' capture seconds and the peak device
     memory are printed;
 6b. the same slice from the same seeds by eager steps (train(...,
     graphs=False)): the weights, Adam's moments, the grid (occs,
     binaries, thre and the query tables), the generator's state and the
     launch counts of the training must equal the graphed run's bitwise;
     both runs' steps/s are printed;
  7. forward-MLP kernel vs its plain version at full width (8x256 seeded
     weights, the 1,048,576 coarse samples of a 128x128 held-out
     SphereScene view at 64 per ray, encoded and padded as
     make_fused_model_fn does): rgb within 5e-3, sigma within 2e-2 of max
     |sigma|, two runs bitwise equal; relu and trunc_exp sigma at 65,573
     rows; CUDA-event times of the kernel, the plain version and the bf16
     NeRF module on the same points (the cuBLAS route), the kernel's time
     and host ms per call at one validation chunk (393,216 rows) and
     ptxas's registers and spills of the warp-specialized kernel;
  8. the hierarchical render slice: render_path over 3 path poses at
     128x128 (64 coarse + 128 fine), once with the fused fine pass (the
     forward MLP, the compositing kernel once per chunk's coarse pass and
     the ray march must launch) and once without it (the forward MLP and
     the compositing kernel for both passes), launch counts read around
     each run;
  9. the hierarchical training slice: train() (graphed) from seeded
     weights on the 8-view 128x128 SphereScene with 64 + 128 samples, then
     the held-out views through evaluate_split, launch counts read around
     that run: the train kernels must launch twice per step (coarse and
     fine pass), the forward MLP and the ray march at least once, the
     compositing kernel once per chunk; the loss must fall, the held-out
     PSNR must rise at least 5 dB above the untrained weights', and the
     eval without the fused fine pass must land within 0.5 dB of it;
 10. the SIREN train kernels vs their plain versions at full width
     (SiNeRF 8x256 with seeded weights, 196,608 rows, an MSE cotangent):
     rgb within 5e-3, sigma within 2e-2 of max |sigma|, every gradient
     within 1e-2 of its max |plain gradient| in each backward mode (saved
     activations and recompute, each against its plain version), the two
     modes within 1e-2 of each other's max, two runs bitwise equal in each
     mode; CUDA-event times of the kernels (the forward with and without
     its acts stream), the plain versions and the bf16 SiNeRF module
     (forward, and its backward by autograd), the forward's host ms per
     call and bound share, the saved mode's three backward launches from
     torch.profiler (its row pass the warp-specialized one), the host ms
     per backward call, and ptxas's registers and spills of both forwards
     and both row passes;
 11. the SIREN ray march vs its plain version on the 16,384 rays of a
     128x128 held-out SphereScene view, a grid rebuilt from a seeded
     SiNeRF's densities, the eval K and the depth-coherence sort, in a
     normal and a saturating case (+5000 on the sigma head's bias): rgb and
     opacity within 7e-3, depth within 3e-2, equal executed-step counts,
     fewer steps when saturated; its early-exit time, host ms per call and
     bound share, and ptxas's registers and spills of both marches;
 12. the SiNeRF training slice: train() from seeded weights on the 8-view
     128x128 SphereScene (occgrid), then the held-out views through
     evaluate_split, launch counts read around that run: the SIREN train
     kernels must launch once per step and the SIREN ray march at least
     once; the loss must fall and the held-out PSNR rise at least 5 dB
     above the untrained weights';
 13. the SiNeRF hierarchical render slice: render_path over 3 path poses
     (64 coarse + 128 fine): the SIREN forward kernel (coarse pass) and the
     SIREN ray march (fine pass) must both launch;
 14. the density kernel vs its plain version at full width (NeRF 8x256
     with seeded weights and a mid-anneal FreeNeRF mask at all 2,097,152
     cell centres of a res-128 grid and one jittered quarter of 524,288
     cells; relu and trunc_exp at 65,573 rows): sigma within 2e-2 of max
     |sigma|, two runs bitwise equal; CUDA-event times of the kernel, the
     plain version and the bf16 module's density (the route it replaces),
     the kernel at one og.update launch's 262,144 rows with its bound
     share, the wrapper's host ms per call and the kernel's ptxas
     registers and spills, and one all-cell and one quarter og.update
     through each route;
 15. the compositing kernel vs volume_render on the card at 16,384 rays x
     64 samples (a 128x128 view's coarse pass through the forward MLP, no
     mask) and x 192 (its occgrid lattice compacted to the validation K,
     with the mask, fully masked rays included): rgb, opacity, depth,
     weights and trans_final within rtol 1e-5 and atol 1e-6, two runs
     bitwise equal; CUDA-event times of both over input
     copies that exceed the L2 cache, replayed from CUDA graphs (the
     device time) and called eagerly (the host's);
 16. the few-shot training slice: train() from seeded weights on 3 views
     of a 128x128 LatticeScene, 1,500 steps with FreeNeRF annealing over
     750 (the auto culling hold), the occlusion regularizer (a 0.003, b 2,
     exp, beta 1), the weight regularizer (ao 1e-6), validation every 500
     steps and a checkpoint at step 1,000, then the held-out views through
     evaluate_split, launch counts read around that run: the train kernels
     once per step, the density kernel at every refresh (8 launches per
     all-cell refresh, 2 per quarter), the compositing kernel and the
     forward MLP once per chunk of each validation; the grid's occupancy
     exactly 1.0 at every logged step through 700 and below 1.0 from 800;
     the loss must fall and the
     held-out PSNR rise at least 5 dB above the untrained weights'; then
     the run resumed from its step-1,000 checkpoint to 1,500 must land
     bitwise on the same weights and grid;
 17. the Blender-format data slice: 40 lattice views (render_lattice_image)
     on the upper hemisphere at radius 4.03, 800x800, camera_angle_x
     0.6911112, written as transforms_train.json and RGBA PNGs (alpha
     where a ray hits) by the port's PNG writer and decoded by its decoder
     (timed); then the command line's flow (fsnerf_tpu_torch.cli.main,
     --dataset synthetic --n_imgs 8 --white_bkgd, the default 8x256
     config, 1,500 steps): the untrained weights' val PSNR (--render_only
     --debug, no checkpoint), the training run into its run directory
     (<out_dir>/nerf/synthetic/<scene>/n_imgs_8; splits 8 / 6 / 6, val
     PSNR at least 5 dB above the untrained, final_metrics.json with the
     val and test
     metrics and lpips null, kernels 5 and 6 once per step, kernel 4 at
     every refresh and kernel 1 launched, counts read around the run, the
     orbit's frames on disk, and --export_render's serving artifact, which
     phase 21c replays) and --render_only from its checkpoint, which
     must write the same frames byte for byte; decode s, steps/s, eval s
     per view and path frames/s printed. The orbit is cut from 90 frames
     to 30 here only (short_paths), as tests/test_cli.py cuts it;
 18. the LLFF-format data slice: 20 forward-facing lattice views at
     504x378 (fern's images_8 size) with a poses_bounds.npy, factor 8;
     the same flow with --dataset llff (NDC rays, 4 grid levels: 32
     density launches per all-cell refresh), the spiral cut from 120
     frames to 40; then 200 steps graphed and eager from the same seeds,
     bitwise equal (weights, Adam, all 4 levels of the grid, the
     generator, the launches), and on the trained weights kernel 1 on a
     val view's NDC samples and kernel 4 on each level's cell centres
     against their plain versions (phase 3's and 14's tolerances);
 19. the kernels at every width up to W_max (a module's width packed at
     64, 128, 192, 256, 384, 512 or a multiple of 256 from 768 up; W_max
     the widest whose packed weights int32 offsets address: 15,872 for
     the NeRF below, 15,360 for the 8-layer SiNeRF):
     a. NeRF 8 layers, skip 4, seeded weights, at widths 40, 96, 192,
        200, 300 (packed 384), 512, 700 (packed 768), 1024, 1100 (packed
        1280), 2048 and W_max (n_freqs 10/4), 256 and 512 with n_freqs 21
        (a 129-wide encoding) and 256 with n_freqs_views 21 (packed 384):
        kernel 1 on phase 3's march inputs (its tolerances, equal executed
        steps), kernel 3 at one validation chunk's 393,216 rows and kernel
        4 at one og.update launch's 262,144 (phase 7's and 14's
        tolerances), kernels 5 and 6 at 196,608 rows (phase 5's, saved ==
        recompute bitwise), launch counts from 0 (at W_max, whose tensors
        at those rows outgrow the card, one ray block per SM, WMAX_ROWS
        rows and the plain versions on the first ray block and on
        WMAX_PLAIN_ROWS); each kernel's CUDA-event
        time beside its plain version's and its bound at the module's own
        width (the padded work is the kernel's cost) and the bf16 module's
        time on the same rows (above 256 timed in fewer calls:
        WIDE_KERNEL_REPS); ptxas's registers and spills of every 384 and
        512 instance, of kernel 6's 64-row row pass and of the streamed
        instances;
     b. SiNeRF 8 layers at 40, 100, 192, 300 (packed 384), 512, 700
        (packed 768), 1024, 1100 (packed 1280), 2048 and W_max: kernels
        7, 8 (both modes) and 2 against their plain versions at 196,608
        rows and phase 3's march inputs (phase 10's and 11's tolerances;
        at W_max as 19a), each kernel bitwise repeatable (from 384 up
        recompute mode bitwise equal to saved mode), its CUDA-event time in
        each of its modes (kernel 7 with and without acts, kernel 8 saved
        and recompute) beside its plain version's, its bound and the bf16
        SiNeRF module's time on the same rows; at 320 packed at 320 (no
        packer's width) the mma.sync forward and march held and timed the
        same way and the backward refused by name; the SIREN kernels' ring
        stages at each width as the C launchers pick them, which must
        equal siren.py::siren_stages; a SiNeRF and a NeRF one unit past
        W_max resolve to the module with the printed line, a SiNeRF and a
        NeRF of 512, 600, 1024, 1100 and 2048 to the kernels; ptxas's
        registers and spills of every width-192 instance and of every SIREN
        instance at 384 and 512 and of the streamed ones (which must spill
        nothing);
     c. the occgrid training slice (200 graphed steps, 150 at 8 x 2048;
        held-out views) at
        8 x 192, 8 x 200, 8 x 512, 8 x 1024 and 8 x 2048 through the
        kernels (counts from 0: kernels 5 and 6 once per step, kernel 4 at
        every refresh, kernel 1 in the eval; no NeRF module call), then the
        same run through the module (fused_kernel and fused_render off, the
        route these widths took before the kernels took them): steps/s and
        held-out PSNR side by side, each at least 5 dB above the untrained
        weights', from 512 up the two within 1 dB (0.5 dB above 1024); then
        the same for SiNeRF 8 x 512 and 8 x 1536 (150 and 120 steps)
        (kernels 7 and 8 once per step, kernel 2 in the eval, no SiNeRF
        module call but the grid refresh's, on the kernels' route);
 20. the data-parallel layer (parallel/) at the training slice's full
     width (NeRF 8x256 skip 4, 1,024 rays a step globally, grid res 128,
     the 8-view 128x128 sphere):
     a. two ranks on cuda:0 over gloo (spawned processes, a FileStore in a
        temp dir), eager steps: 20 parallel steps against 20 single-GPU
        eager steps from the same seeds (the same draws), the loss and the
        weights within 1e-2 (of max |weight|), the two ranks' weights
        bitwise equal after every step; then an all-cell and a part
        refresh sharded through kernel 4 and one 128x128 view tiled
        through kernel 1, each bitwise the single-GPU result; steps/s and
        the gloo all-reduce's ms per step;
     b. one rank over NCCL, graphed: 200 steps of train(..., mesh=)
        against the same 200 steps of the single-GPU graphed loop: the
        weights, Adam moments, grid, generator and launch counts bitwise
        equal;
     c. LPIPS with seeded random weights (an npz written here) on two
        128x128 frames on the card against the same on the CPU, within
        1e-4 relative, TF32 off;
 21. the serving artifact (fsnerf_tpu_torch/utils/export.py), launch
     counts set to 0 before each replay and read after it:
     a. NeRF 8x256 with phase 3's seeded weights and res-128 grid:
        cli.serving_renderer (the eval model_fn, kernel 3 through its op,
        the plain compositing, chunks of 2,048 rays, the path's K) on 4
        path poses of the 128x128 sphere exported with torch.export on the
        card, saved and loaded; render_frame_exported of each pose must
        equal render_frame through the live renderer bitwise, kernel 3
        launching once per chunk of the replay, and compact_transfer give
        to8b of the f32 frame; export and load seconds, the artifact's MB
        and frames/s of both routes printed;
     b. the same for a seeded SiNeRF 8x256 on a grid rebuilt from its
        densities (kernel 7 without acts through its op);
     then a fresh process importing torch and the port's op library only
     (no model, config, checkpoint or renderer module) loads both
     artifacts and replays a chunk of each, bitwise this process's replay
     with one launch each;
     c. phase 17's --export_render artifact renders the first test view
        (kernel 3 once per chunk): bitwise the view through
        cli.serving_renderer rebuilt from the run's checkpoint, and within
        phase 9's 0.5 dB in PSNR of the CLI's own render of that view (the
        eval route: kernel 1 on the checkpoint's weights and grid) at the
        artifact's K, the largest differences and the pixels beyond
        kernel 1's tolerances (rgb 7e-3, depth 3e-2) printed;
 22. JPEG on the card's machine, which has no libjpeg (the port's
     decoder, fsnerf_tpu_torch/native):
     a. tests/data/jpeg/'s fixtures (progressive, 4:2:0 with restarts,
        gray, 4:2:2, 4:4:0, RGB; widths and heights no MCU divides) decoded
        bitwise to the pixels libjpeg-turbo gives (pixels.npz);
     b. phase 18's lattice scene with its images_8/ written as JPEG by PIL
        (quality 95, 4:2:0; PIL's JPEG codec must be present): the views
        against PIL's decode of them, then the CLI's LLFF flow with
        --debug (splits, LLFF_STEPS steps, val and test): the splits, val
        PSNR at least 5 dB above the untrained weights', kernels 5 and 6
        once per step, kernel 4 at every refresh and kernel 1 launched;
        the val PSNR printed beside phase 18's PNG run;
     c. 20 views at 4032x3024 (4:2:0, quality 95) decoded as images/s and
        megapixels/s, beside PIL's decode of the same files;
 23. the nearest cuBLAS route of each kernel (the bf16 NeRF or SiNeRF
     module on the same rows: no single PyTorch call computes these
     functions), one JSON line describing each kernel with its bound (the
     larger of its bytes over 3.35 TB/s and its FLOP over 989 TFLOP/s in
     bf16, or 67 TFLOP/s in float32 for the compositing kernel, from this
     run's shapes and executed work; the two train backwards also with the
     ms of each launch, `parts_ms`), then the device line.
Exits non-zero without printing a result when CUDA is unavailable.
"""

import contextlib
import gc
import json
import logging
import math
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RGB_OPACITY_TOL = 7e-3      # tests/test_pallas.py ray-march tolerances
DEPTH_TOL = 3e-2
SATURATING_SIGMA_BIAS = 5000.0
# Train kernels vs plain, tighter than the JAX package's fused-MLP
# tolerances (rgb 5e-3, sigma 2e-2 of max, gradients 2e-2 of max): on an
# H100 the kernels reached rgb 9.0e-5, sigma 2.2e-3 of max and gradients
# 4.2e-3 of max at these inputs.
TRAIN_RGB_TOL = 1e-3
TRAIN_SIGMA_TOL = 1e-2      # of max |sigma|
GRAD_TOL = 1e-2             # of each gradient's max |plain gradient|
TRAIN_ROWS = 1024 * 192     # batch x compaction ceiling
TRAIN_STEPS = 1500
MIN_PSNR_GAIN_DB = 5.0
# the forward MLP vs plain: tests/test_pallas.py's fused-MLP tolerances
MLP_RGB_TOL = 5e-3
MLP_SIGMA_TOL = 2e-2        # of max |sigma|
VAL_CHUNK_ROWS = 2048 * 192  # one validation chunk: 2 x batch rays x K 192
HIER_COARSE, HIER_FINE = 64, 128    # BASELINE.json config 2
HIER_STEPS = 1500
HIER_FUSED_PSNR_TOL_DB = 0.5
SIREN_STEPS = 1500
# the few-shot slice: kernel 4 refreshes its grid, kernel 9 composites
# its validation renders
FEWSHOT_STEPS, FEWSHOT_ANNEAL, FEWSHOT_CKPT, FEWSHOT_VAL = 1500, 750, 1000, 500
# the data slices: a Blender-format scene (800x800 RGBA, the published
# camera_angle_x) and an LLFF-format one (fern's images_8 size), both
# synthesized from the lattice, run through the command line
BLENDER_HW, BLENDER_VIEWS, BLENDER_STEPS = 800, 40, 1500
CAMERA_ANGLE_X = 0.6911112
LLFF_W, LLFF_H, LLFF_FOCAL, LLFF_VIEWS = 504, 378, 407.0, 20
LLFF_STEPS, LLFF_GRAPH_STEPS = 1500, 200
# the camera paths cut to a third here only (the 90-frame orbit at 800²
# took 42 s and the 120-frame spiral 15 s per render on the card, and each
# slice renders its path twice)
BLENDER_PATH_FRAMES, LLFF_PATH_FRAMES = 30, 40
# the density kernel vs plain: the ceiling of tests/test_pallas.py::
# test_fused_density_matches_model
DENSITY_SIGMA_TOL = 2e-2    # of max |sigma|
# the compositing kernel vs volume_render: tests/test_pallas.py's volrend
# tolerance
VOLREND_RTOL, VOLREND_ATOL = 1e-5, 1e-6
# the H100 SXM's published peaks (the roofline of the kernels' bound)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the current stream, after one
    untimed call (a first cuBLAS call at new shapes also loads and picks
    its kernels); reps 0: one call, no untimed one (a call of seconds)."""
    if reps == 0:
        return once_ms(fn)
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, march, reference, padded, params, bR, cs, eps,
            quick=0, plain_rays=None):
    """A ray-march kernel vs its plain version on the same inputs; returns
    the numbers for the report and the kernel's outputs ("first"). With
    `quick` calls the plain version is timed by its comparison call alone
    and the kernel over that many. With `plain_rays` the plain version
    marches the first plain_rays rays alone, held against those rays of
    the kernel's launch."""
    first = march(*padded, params, bR, cs, eps)
    got, steps = first
    total = steps.numel() * (padded[0].shape[1] // cs)
    executed = int(steps.sum())
    sub = padded
    if plain_rays is not None:
        sub = tuple(a[:plain_rays].contiguous() for a in padded)
        got, steps = got[:plain_rays], steps[:plain_rays // bR]
    plain_once = {}

    def plain_call():
        plain_once["out"] = reference(*sub, params, bR, cs, eps)

    plain_once_ms = once_ms(plain_call)
    ref, steps_ref = plain_once.pop("out")
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    err = (got - ref).abs().amax(dim=0).cpu()
    if err[:4].max() > RGB_OPACITY_TOL or err[4] > DEPTH_TOL:
        fail(f"{name}: kernel vs plain max abs err {err.tolist()}")
    if not torch.equal(steps, steps_ref):
        fail(f"{name}: executed steps {int(steps.sum())} (kernel) != "
             f"{int(steps_ref.sum())} (plain)")

    def kernel():
        march(*padded, params, bR, cs, eps)

    def plain():
        reference(*sub, params, bR, cs, eps)

    if quick:
        ms, plain_ms = cuda_ms(kernel, quick), plain_once_ms
    else:
        ms, plain_ms = in_turns(plain, kernel)
    out = dict(max_abs_err=float(err[:5].max()), ms=ms, plain_ms=plain_ms,
               executed=executed, total=total, first=first)
    print(f"{name}: max abs err rgb/opacity {float(err[:4].max()):.3e} "
          f"depth {float(err[4]):.3e}; steps {executed}/{total} "
          f"(skip fraction {1 - executed / total:.4f}); kernel "
          f"{out['ms']:.3f} ms, plain {out['plain_ms']:.3f} ms")
    return out


def march_inputs(cfg, grid, split, dev):
    """The ray march's padded inputs for the first view of `split`, as the
    render path builds them: its rays (NDC for an NDC split), lattice, grid
    mask, compaction to the eval K, depth-coherence sort. Returns (padded,
    block rows, chunk, eval K)."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.data.rays import get_rays, to_ndc
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.sampling import (compact_samples_uniform,
                                               sample_points)
    from fsnerf_tpu_torch.render.renderer import _masked_lattice

    s = cfg.sampling
    eval_k = cli.derive_eval_n_compact(grid, split, cfg, dev)
    q_stride = og.grid_query_stride(s, split.aabb, grid)
    pose = torch.as_tensor(split.poses[0], dtype=torch.float32, device=dev)
    ro, rd = (a.reshape(-1, 3) for a in get_rays(pose, split.hwf))
    if split.ndc:
        ro, rd = to_ndc(ro, rd, split.hwf, 1.0)
    with torch.no_grad():
        t_mid, deltas, mask, n_valid = _masked_lattice(
            ro, rd, grid, s.n_samples, None, s.render_step_size,
            s.early_stop_eps, q_stride)
        t_k, d_k, m_k = compact_samples_uniform(t_mid, deltas[:, 0], mask,
                                                eval_k)
        x = sample_points(ro, rd, t_k)
        perm = torch.sort(n_valid, stable=True).indices
        padded, bR, cs = kr.pad_for_march(x[perm], rd[perm], t_k[perm],
                                          d_k[perm], m_k[perm])
    print(f"rays {ro.shape[0]}, eval K {eval_k}, query stride {q_stride}, "
          f"mean valid samples {float(n_valid.mean()):.1f}, "
          f"block {bR} x chunk {cs}")
    return padded, bR, cs, eval_k


def graphed(fn, calls: int):
    """The replay of a CUDA graph of `calls` calls of fn: for a call whose
    host time exceeds its device time, where CUDA events around eager calls
    would time the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph.replay


def in_turns(plain, kernel, plain_reps=3, kernel_reps=10, quick=0):
    """CUDA-event ms of plain and kernel, timed plain, kernel, kernel,
    plain; with `quick` calls (phase 19 from the streamed widths up, where
    one plain call takes seconds) the kernel over that many calls after an
    untimed one and the plain version in one call."""
    if quick:
        return cuda_ms(kernel, quick), once_ms(plain)
    p1, k1, k2, p2 = (cuda_ms(plain, plain_reps), cuda_ms(kernel, kernel_reps),
                      cuda_ms(kernel, kernel_reps), cuda_ms(plain, plain_reps))
    return (k1 + k2) / 2, (p1 + p2) / 2


def once_ms(fn) -> float:
    """CUDA-event milliseconds of one call of fn."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# the launches of each train backward, in order (csrc/mlp_train.cu,
# csrc/siren.cu and their shared weight-gradient pass, train_common.cuh)
NERF_BWD_PARTS = ("mlp_train_bwd_rows_kernel", "dw_gemm_kernel",
                  "dw_reduce_kernel")
SIREN_BWD_PARTS = ("siren_bwd_rows_ws_kernel", "dw_gemm_kernel",
                   "dw_reduce_kernel")


def host_ms_per_call(fn, calls: int = 50) -> float:
    """Host ms per call of fn: from the first of `calls` calls' start to the
    last one's return, before the card is waited for (after one untimed
    call and a wait)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return host_ms


def ptxas_of(log: str, kernel: str) -> str:
    """ptxas's register and spill lines for each entry function whose
    mangled name holds `kernel` (its width from the template argument),
    from the build's -Xptxas -v log."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = None
            if kernel in line:
                width = re.search(r"ILi(\d+)E", line)
                save = re.search(r"I(?:Li\d+E)?Lb([01])E", line)
                args = ([width.group(1)] if width else []) + (
                    ["true" if save.group(1) == "1" else "false"]
                    if save else [])
                cur = f"{kernel}<{', '.join(args)}>" if args else kernel
        elif cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.split(':', 1)[-1].strip()}")
    return "\n".join(f"  ptxas: {o}" for o in out) or "  ptxas: (no log)"


def kernel_events(fn, calls: int = 1) -> list:
    """The kernel events of a torch.profiler trace of `calls` calls of fn
    (the card is waited for inside)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return [e for e in json.load(fh)["traceEvents"]
                    if e.get("cat") == "kernel"]


def kernel_split_ms(fn, names, calls: int = 5):
    """(device ms per call of fn in each of the kernels `names` (each
    launched once per call), host ms per call): the device times are the
    mean of the kernel events of a torch.profiler trace over `calls` calls
    (after one untimed call; the profiler may keep the events of only some
    of them), the host time that of `calls` untraced calls, from the first
    call's start to the last one's return, before the card is waited for.
    Fails if a named kernel left no event."""
    host_ms = host_ms_per_call(fn, calls)
    durs = {name: [] for name in names}
    for e in kernel_events(fn, calls):
        if "dur" not in e:
            continue
        for name in names:
            if name in e["name"]:
                durs[name].append(e["dur"] / 1e3)
                break
    missing = [name for name, d in durs.items() if not d]
    if missing:
        fail(f"the profiler saw no kernel events of {missing}")
    return {name: sum(d) / len(d) for name, d in durs.items()}, host_ms


def require_kernels(phase: str, fn, names, width: int, plain=()) -> set:
    """Fail unless one call of fn launches each kernel of `names` at
    template width `width` (the route the main path must take; the
    profiler's names demangled, kernel<256, ...>, or mangled,
    kernelILi256E...) and each of `plain` (no template argument); print
    them. Returns the names of every kernel the profiler saw."""
    seen = {e["name"] for e in kernel_events(fn)}
    found = {n: sorted(k for k in seen if f"{n}<{width}" in k
                       or f"{n}ILi{width}E" in k) for n in names}
    found.update({n: sorted(k for k in seen if n in k) for n in plain})
    missing = [n for n, ks_ in found.items() if not ks_]
    if missing:
        fail(f"{phase}: the profiler saw no kernel named {missing} "
             f"(saw {sorted(seen)})")
    print(f"{phase}: kernels launched (profiler) "
          + "; ".join(f"{k[:90]}" for v in found.values() for k in v))
    return seen


def siren_routes(cfg, dev, card):
    """Phase 2, after the build: the SiNeRF main path's calls at full width
    under torch.profiler, each of which must launch the warp-specialized
    kernels (the routes phases 10-13 then take): the SIREN forward with and
    without its acts stream at 196,608 rows (siren_fwd_ws_kernel), the
    SIREN march at 16,384 rays x K 192 (siren_march_kernel), five train
    steps (siren_fwd_ws_kernel, siren_bwd_rows_ws_kernel), the held-out
    eval of one view (siren_march_kernel) and one frame of the hierarchical
    render (siren_fwd_ws_kernel, siren_march_kernel). They run before the
    long slices: a trace taken after the process has traced once and then
    trained can lose kernel records (one taken after phase 9 saw neither of
    its two kernels on an H100 with torch 2.11)."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.config import DataConfig
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.render.renderer import render_path
    from fsnerf_tpu_torch.train.loop import train

    scfg = sinerf_config(cfg, n_iters=5).replace(
        data=DataConfig(dataset="sphere", n_imgs=8, white_bkgd=True))
    L, W = scfg.model.n_layers, scfg.model.d_filter
    model = make_model(scfg, torch.bfloat16,
                       torch.Generator().manual_seed(3), dev)
    params = ks.prep_siren_params(model.state_dict(), L)
    g = torch.Generator(device=dev).manual_seed(4)
    xp = ks.pad_inputs(torch.rand((TRAIN_ROWS, 3), generator=g,
                                  device=dev) * 3.0 - 1.5)
    dp = ks.pad_inputs(torch.nn.functional.normalize(
        torch.randn((TRAIN_ROWS, 3), generator=g, device=dev), dim=-1))
    for save in (True, False):
        require_kernels(f"the SIREN forward (save_acts={save})",
                        lambda: ks.siren_mlp_fwd(xp, dp, params, save),
                        ("siren_fwd_ws_kernel",), W)
    R, K = 16_384, 192
    x = torch.rand((R, K, 3), generator=g, device=dev) * 3.0 - 1.5
    dirs = torch.nn.functional.normalize(
        torch.randn((R, 3), generator=g, device=dev), dim=-1)
    t = torch.sort(torch.rand((R, K), generator=g, device=dev) * 4.0 + 2.0,
                   dim=-1).values
    deltas = torch.full((R, K), 5e-3, device=dev)
    mask = torch.ones((R, K), device=dev)
    require_kernels("the SIREN march",
                    lambda: kr.siren_ray_march(x, dirs, t, deltas, mask,
                                               params, 16, 8),
                    ("siren_march_kernel",), W)
    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    state = None

    def steps():
        nonlocal state
        state = train(model, scfg, pool, scene, logger=ListLogger(),
                      log_every=5)

    require_kernels("five SiNeRF train steps", steps,
                    ("siren_fwd_ws_kernel", "siren_bwd_rows_ws_kernel"), W)
    held = cli.split_of(scene.holdout(n=1, seed=101))
    require_kernels("the SiNeRF held-out eval",
                    lambda: cli.evaluate_split(
                        model, og.conservative(state.grid), held, scfg,
                        device=dev),
                    ("siren_march_kernel",), W)
    hcfg = sinerf_config(hier_config(cfg))
    require_kernels(
        "one frame of the SiNeRF hierarchical render",
        lambda: render_path(
            cli.make_render_model_fn(model, hcfg, device=dev),
            scene.path_poses[:1], scene.hwf, scene.near, scene.far,
            device=dev, strategy="hierarchical", n_samples=HIER_COARSE,
            n_fine=HIER_FINE, white_bkgd=True,
            fused_render_fn=cli.make_fused_render_fn(model.state_dict(),
                                                     hcfg, device=dev)),
        ("siren_fwd_ws_kernel", "siren_march_kernel"), W)


def train_kernels(cfg, dev, card):
    """Phase 5: the train kernels vs their plain versions at full width,
    and the device time of each of the backward's launches."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    lay = mt.TrainLayout.from_config(cfg)
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(3), dev)
    params = mt.pack_train_params(
        model.state_dict(), lay,
        kr.enc_table(lay.n_freqs, lay.n_freqs_views, device=dev))
    g = torch.Generator(device=dev).manual_seed(4)
    n = TRAIN_ROWS
    x = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    target = torch.cat([torch.rand((n, 3), generator=g, device=dev),
                        torch.zeros((n, 1), device=dev)], dim=-1)
    out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    out2, acts2 = mt.mlp_train_fwd(x, d, params, save_acts=True)
    ref, _ = mt.mlp_train_fwd_reference(x, d, params)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail("train forward: kernel output is not finite")
    if not (torch.equal(out, out2) and torch.equal(acts, acts2)):
        fail("train forward: two kernel runs differ")
    rgb_err = float((out[:, :3] - ref[:, :3]).abs().max())
    sig_err = float((out[:, 3] - ref[:, 3]).abs().max())
    sig_scale = float(ref[:, 3].abs().max()) + 1e-9
    if rgb_err > TRAIN_RGB_TOL or sig_err / sig_scale > TRAIN_SIGMA_TOL:
        fail(f"train forward vs plain: rgb err {rgb_err:.3e}, sigma err "
             f"{sig_err:.3e} of max {sig_scale:.3e}")
    dout = (2.0 * (ref - target) / ref.numel()).contiguous()
    saved = mt.mlp_train_bwd(x, d, dout, params, acts)
    again = mt.mlp_train_bwd(x, d, dout, params, acts)
    recomputed = mt.mlp_train_bwd(x, d, dout, params, None)
    plain = mt.mlp_train_bwd_reference(x, d, dout, params)
    torch.cuda.synchronize()
    for a, b, c in zip(saved, again, recomputed):
        if not torch.equal(a, b):
            fail("train backward: two kernel runs differ")
        if not torch.equal(a, c):
            fail("train backward: saved-acts and recompute grads differ")
    worst, grad_abs = ("", 0.0), 0.0
    for name, gk, gp in zip(lay.param_names, lay.grads_from_packed(*saved),
                            lay.grads_from_packed(*plain)):
        abs_err = float((gk - gp).abs().max())
        rel = abs_err / (float(gp.abs().max()) + 1e-30)
        grad_abs = max(grad_abs, abs_err)
        if rel > worst[1]:
            worst = (name, rel)
    if worst[1] > GRAD_TOL:
        fail(f"train backward vs plain: {worst[0]} off by {worst[1]:.3e} of "
             "its max")

    fwd_ms, fwd_plain_ms = in_turns(
        lambda: mt.mlp_train_fwd_reference(x, d, params, True),
        lambda: mt.mlp_train_fwd(x, d, params, True))
    fwd_host_ms = host_ms_per_call(
        lambda: mt.mlp_train_fwd(x, d, params, True))
    weights = (params.wpack, params.bpack, params.enc)
    fwd_bound = bound(2.0 * mlp_macs(cfg) * n,
                      nbytes(x, d, *weights, out, acts))
    bwd_bound = bound(2.0 * bwd_macs(cfg) * n,
                      nbytes(x, d, dout, acts, *weights, *saved))
    bwd_ms, bwd_plain_ms = in_turns(
        lambda: mt.mlp_train_bwd_reference(x, d, dout, params, acts),
        lambda: mt.mlp_train_bwd(x, d, dout, params, acts))
    recompute_ms = cuda_ms(lambda: mt.mlp_train_bwd(x, d, dout, params, None),
                           10)
    parts, host_ms = kernel_split_ms(
        lambda: mt.mlp_train_bwd(x, d, dout, params, acts), NERF_BWD_PARTS)
    print(f"train kernels at {n} rows on {card}: forward max abs err rgb "
          f"{rgb_err:.3e} sigma {sig_err:.3e} (max |sigma| "
          f"{sig_scale:.3e}); gradients worst {worst[0]} at {worst[1]:.3e} "
          f"of its max, max abs err {grad_abs:.3e}; bitwise repeatable, "
          f"saved == recompute; forward {fwd_ms:.3f} ms (plain "
          f"{fwd_plain_ms:.3f}; bound share "
          f"{fwd_bound['bound_ms'] / fwd_ms:.3f}; host {fwd_host_ms:.4f} ms "
          f"per call), backward {bwd_ms:.3f} ms (plain {bwd_plain_ms:.3f}; "
          f"recompute mode {recompute_ms:.3f})")
    print("train backward's launches (profiler, saved activations): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f"; host {host_ms:.4f} ms per call")
    return (dict(max_abs_err=max(rgb_err, sig_err), ms=fwd_ms,
                 plain_ms=fwd_plain_ms, **fwd_bound),
            dict(max_abs_err=grad_abs, ms=bwd_ms, plain_ms=bwd_plain_ms,
                 parts_ms=parts, **bwd_bound))


class ListLogger:
    """The train loop's logger, kept in memory, each record stamped with
    the host clock (`t`) when the loop logs it: after it has read the
    step's metrics back, so after the card finished that step."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics):
        self.records.append({"step": step, "t": time.perf_counter(),
                             **metrics})

    def steady_steps_per_s(self, after: int = 100) -> float:
        """Steps/s from the first logged step at or past `after` to the
        last: the run without its first steps, which pay the one-time
        costs (the process's first launch of each kernel, the first graph
        captures) that depend on what ran before it in the process."""
        recs = [r for r in self.records if "loss" in r and r["step"] >= after]
        if len(recs) < 2:
            fail(f"no two train records past step {after}")
        return (recs[-1]["step"] - recs[0]["step"]) / (
            recs[-1]["t"] - recs[0]["t"])


class GraphRecords(logging.Handler):
    """The CUDA-graph rungs train() logs as it retires their step
    functions (train/loop.py: K, each kind's capture seconds)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rungs = []

    def emit(self, record):
        if hasattr(record, "graphs"):
            self.rungs.append(record.graphs)

    def __enter__(self):
        log = logging.getLogger("fsnerf_tpu_torch.train.loop")
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("fsnerf_tpu_torch.train.loop").removeHandler(self)

    def summary(self) -> str:
        caps = [sum(r["capture_s"].values()) for r in self.rungs]
        return (f"{len(self.rungs)} rungs (K "
                + ", ".join(str(r["n_compact"]) for r in self.rungs)
                + f"), {sum(len(r['capture_s']) for r in self.rungs)} "
                f"graphs captured in {sum(caps):.3f} s (per rung "
                + ", ".join(f"{c:.3f}" for c in caps) + " s)")


def train_slice_config(cfg):
    import dataclasses

    from fsnerf_tpu_torch.config import DataConfig

    return cfg.replace(
        data=DataConfig(dataset="sphere", n_imgs=8, white_bkgd=True),
        train=dataclasses.replace(cfg.train, n_iters=TRAIN_STEPS))


def run_train_slice(tcfg, dev, graphs=None, mesh=None):
    """train() of the occgrid slice from seeded weights on the 8-view
    128x128 sphere (over `mesh` when given): (model, state, logger, launch
    counts the training added, seconds, graph rungs, peak device GB
    allocated and reserved: the graphs' pools hold their memory between
    replays, which only the reserved peak counts)."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops.kernels import launch_counts
    from fsnerf_tpu_torch.train.loop import train

    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    model = make_model(tcfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    log = ListLogger()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    with GraphRecords() as rungs:
        state = train(model, tcfg, pool, scene, logger=log, log_every=100,
                      graphs=graphs, mesh=mesh)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    after = launch_counts()
    return (model, state, log, {k: after[k] - before[k] for k in after},
            seconds, rungs, (torch.cuda.max_memory_allocated() / 2 ** 30,
                             torch.cuda.max_memory_reserved() / 2 ** 30))


def train_slice(cfg, dev, card):
    """Phase 6: train (CUDA graphs), then render the held-out views on the
    trained grid. Returns (the launch counts of the run, the graphed
    training's state, launch counts and steps/s for phase 6b)."""

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    tcfg = train_slice_config(cfg)
    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    held = cli.split_of(scene.holdout(n=3, seed=101))
    untrained = make_model(tcfg, torch.bfloat16,
                           torch.Generator().manual_seed(0), dev)
    base, _ = cli.evaluate_split(
        untrained, og.conservative(cli.rebuild_grid(
            untrained, tcfg, scene.aabb, dev)), held, tcfg, device=dev)

    kr.ray_march.launches = km.nerf_density.launches = 0
    mt.mlp_train_fwd.launches = mt.mlp_train_bwd.launches = 0
    model, state, log, trained, train_s, rungs, peak_gb = run_train_slice(
        tcfg, dev)
    eval_grid = og.conservative(state.grid)
    got, _ = cli.evaluate_split(model, eval_grid, held, tcfg, device=dev)
    torch.cuda.synchronize()
    launches = {"ray_march": kr.ray_march.launches,
                "mlp_train_fwd": mt.mlp_train_fwd.launches,
                "mlp_train_bwd": mt.mlp_train_bwd.launches,
                "nerf_density": km.nerf_density.launches}

    losses = [r["loss"] for r in log.records]
    print(f"train slice on {card}: {state.step} steps in {train_s:.3f} s, "
          f"{state.step / train_s:.2f} steps/s, "
          f"{state.step * tcfg.train.batch_size / train_s:.0f} rays/s "
          f"(first call included); loss {losses[0]:.5f} at step "
          f"{log.records[0]['step']} -> {losses[-1]:.5f}; final K "
          f"{log.records[-1]['n_compact']:.0f}, occupancy "
          f"{log.records[-1]['occupancy']:.4f}; launches {launches}")
    print(f"train slice graphs: {rungs.summary()}; peak device memory "
          f"{peak_gb[0]:.2f} GB allocated, {peak_gb[1]:.2f} GB reserved")
    print(f"held-out (3 views 128x128): PSNR {got['psnr']:.3f} SSIM "
          f"{got['ssim']:.4f} eval K {got['eval_k']} after training; "
          f"untrained PSNR {base['psnr']:.3f} SSIM {base['ssim']:.4f} "
          f"eval K {base['eval_k']}")
    if min(launches.values()) == 0:
        fail(f"the training slice did not launch every kernel: {launches}")
    want_density = refresh_launches(tcfg, state.grid.n_cells, state.step)
    if launches["nerf_density"] != want_density:
        fail(f"the grid refreshes launched the density kernel "
             f"{launches['nerf_density']} times, not {want_density}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    if got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
        fail(f"held-out PSNR {got['psnr']:.3f} is not {MIN_PSNR_GAIN_DB} dB "
             f"above the untrained {base['psnr']:.3f}")
    # the ray march on trained weights: skip fraction of a held-out view
    padded, bR, cs, _ = march_inputs(tcfg, eval_grid, held, dev)
    sd = model.state_dict()
    params = kr.prep_params(sd, n_layers=cfg.model.n_layers,
                            skip=cfg.model.skip, n_freqs=cfg.encoder.n_freqs,
                            n_freqs_views=cfg.encoder.n_freqs_views,
                            device=dev)
    compare("trained", kr.ray_march, kr.ray_march_reference, padded, params,
            bR, cs, tcfg.sampling.early_stop_eps)
    return launches, (state, trained, state.step / train_s)


def state_diffs(a, b) -> list:
    """The names of what differs between two TrainStates, bitwise: each
    weight and its Adam moments and count, every grid tensor (all
    levels), the generator's state."""
    diffs = {}
    for (name, pa), pb in zip(a.model.named_parameters(),
                              b.model.parameters()):
        diffs[name] = not torch.equal(pa, pb)
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            diffs[f"{name}.{k}"] = not torch.equal(sa[k], sb[k])
    for k in ("occs", "binaries", "thre", "occ_q", "od_q"):
        diffs[f"grid.{k}"] = not torch.equal(getattr(a.grid, k),
                                             getattr(b.grid, k))
    diffs["generator"] = not torch.equal(a.generator.get_state(),
                                         b.generator.get_state())
    return [k for k, v in diffs.items() if v]


def graphed_vs_eager(cfg, dev, card, graphed):
    """Phase 6b: the occgrid slice of phase 6 again from the same seeds,
    trained by eager steps; the graphed run's weights, Adam moments, grid
    (occs, binaries, thre, query tables), generator state and launch
    counts must equal the eager run's bitwise."""
    g_state, g_launches, g_rate = graphed
    _, e_state, _, e_launches, e_s, _, e_peak = run_train_slice(
        train_slice_config(cfg), dev, graphs=False)
    differ = state_diffs(g_state, e_state)
    if g_launches != e_launches:
        differ.append("launches")
    print(f"graphed vs eager on {card}: {e_state.step} steps, graphed "
          f"{g_rate:.2f} steps/s, eager {e_state.step / e_s:.2f} steps/s "
          f"(peak device memory eager {e_peak[0]:.2f} GB allocated, "
          f"{e_peak[1]:.2f} GB reserved); weights, Adam "
          f"moments, grid, generator and launches "
          + ("bitwise equal" if not differ else f"differ: {differ}")
          + f"; launches {g_launches}")
    if differ or g_state.step != e_state.step:
        fail(f"the graphed training differs from the eager loop: {differ}")


def density_macs(cfg) -> int:
    """Multiply-adds of one row of the NeRF trunk and sigma head at the
    config's widths (the unpadded encoding: the work the function asks
    for)."""
    L, W, skip = cfg.model.n_layers, cfg.model.d_filter, cfg.model.skip
    de = 3 * (1 + 2 * cfg.encoder.n_freqs)
    return de * W + sum(W * W + (de * W if (i - 1) in skip else 0)
                        for i in range(1, L)) + W


def mlp_macs(cfg) -> int:
    """Multiply-adds of one NeRF MLP row at the config's widths: the trunk
    and sigma head, the connection, the view branch and the rgb head."""
    W = cfg.model.d_filter
    dd = 3 * (1 + 2 * cfg.encoder.n_freqs_views)
    return density_macs(cfg) + W * W + (W + dd) * (W // 2) + (W // 2) * 3


def refresh_launches(cfg, n_cells: int, steps: int) -> int:
    """The density kernel's launches in `steps` training steps: og.update
    evaluates its cells in chunks of _EVAL_CHUNK per level, all cells
    before warmup_steps and one of update_parts parts after, at every
    refresh step."""
    from fsnerf_tpu_torch.ops.occgrid import _EVAL_CHUNK
    from fsnerf_tpu_torch.train.step import resolve_update_interval

    s, total = cfg.sampling, 0
    for k in range(steps):
        if k % resolve_update_interval(s, k) == 0:
            cells = n_cells if k < s.warmup_steps else \
                n_cells // s.update_parts
            total += -(-cells // _EVAL_CHUNK) * s.grid_levels
    return total


def bwd_macs(cfg) -> int:
    """Multiply-adds of one row of the MLP's weight-gradient backward from
    saved trunk activations: the heads' recompute, the input-cotangent
    products down to layer 1, and the weight-gradient products."""
    L, W = cfg.model.n_layers, cfg.model.d_filter
    dd = 3 * (1 + 2 * cfg.encoder.n_freqs_views)
    heads = W * W + (W + dd) * (W // 2) + (W // 2) * 3
    dx = (L - 1) * W * W + W * W + W + W * (W // 2) + (W // 2) * 3
    return heads + dx + mlp_macs(cfg)


def nbytes(*tensors) -> int:
    return sum(a.numel() * a.element_size() for a in tensors)


def bound(flops: float, moved: int, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time at the published peaks (bf16 tensor-core FLOP/s by
    default), and which of the two sets it."""
    ops_ms = flops / peak * 1e3
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def mlp_kernel(cfg, dev, card, log):
    """Phase 7: the forward MLP kernel vs its plain version at full width,
    its time at one validation chunk's rows, its host ms per call and
    ptxas's lines for it. Returns (the report's numbers, the rows' module
    time in ms)."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.encoding import positional_encoding
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.rays import get_rays
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.sampling import (sample_points,
                                               stratified_samples)

    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(5), dev)
    params = km.prep_params(model.state_dict(), cfg.model.n_layers,
                            cfg.model.skip, dev)
    held = cli.build_split("sphere", 1, 128, True, seed=101)
    pose = torch.as_tensor(held.poses[0], dtype=torch.float32, device=dev)
    ro, rd = (a.reshape(-1, 3) for a in get_rays(pose, held.hwf))
    with torch.no_grad():
        t_c, _ = stratified_samples(ro, rd, held.near, held.far,
                                    HIER_COARSE)
        x = sample_points(ro, rd, t_c).reshape(-1, 3)
        d = rd[:, None, :].expand(-1, HIER_COARSE, 3).reshape(-1, 3)
        encx = km.pad_features(positional_encoding(x, cfg.encoder.n_freqs),
                               params.d_enc_pad)
        encd = km.pad_features(
            positional_encoding(d, cfg.encoder.n_freqs_views),
            params.d_dir_pad)
    n = encx.shape[0]
    out = km.nerf_mlp(encx, encd, params)
    again = km.nerf_mlp(encx, encd, params)
    ref = km.nerf_mlp_reference(encx, encd, params)
    torch.cuda.synchronize()
    if out.shape != (n, 4) or not torch.isfinite(out).all():
        fail("forward MLP: kernel output is not finite or misshapen")
    if not torch.equal(out, again):
        fail("forward MLP: two kernel runs differ")
    rgb_err = float((out[:, :3] - ref[:, :3]).abs().max())
    sig_err = float((out[:, 3] - ref[:, 3]).abs().max())
    sig_scale = float(ref[:, 3].abs().max()) + 1e-9
    if rgb_err > MLP_RGB_TOL or sig_err / sig_scale > MLP_SIGMA_TOL:
        fail(f"forward MLP vs plain: rgb err {rgb_err:.3e}, sigma err "
             f"{sig_err:.3e} of max {sig_scale:.3e}")
    acts = []
    small = 65_536 + 37
    for act in ("relu", "trunc_exp"):
        a_out = km.nerf_mlp(encx[:small], encd[:small], params, act)
        a_ref = km.nerf_mlp_reference(encx[:small], encd[:small], params,
                                      act)
        torch.cuda.synchronize()
        a_rgb = float((a_out[:, :3] - a_ref[:, :3]).abs().max())
        a_sig = float((a_out[:, 3] - a_ref[:, 3]).abs().max()) / (
            float(a_ref[:, 3].abs().max()) + 1e-9)
        if not torch.isfinite(a_out).all() or a_rgb > MLP_RGB_TOL or \
                a_sig > MLP_SIGMA_TOL or (a_out[:, 3] < 0).any():
            fail(f"forward MLP {act}: rgb err {a_rgb:.3e}, sigma err "
                 f"{a_sig:.3e} of max")
        acts.append(f"{act} rgb {a_rgb:.3e} sigma {a_sig:.3e} of max")
    ms, plain_ms = in_turns(lambda: km.nerf_mlp_reference(encx, encd, params),
                            lambda: km.nerf_mlp(encx, encd, params))
    chunk = VAL_CHUNK_ROWS
    chunk_ms = cuda_ms(lambda: km.nerf_mlp(encx[:chunk], encd[:chunk],
                                           params), 20)
    host_ms = host_ms_per_call(
        lambda: km.nerf_mlp(encx[:chunk], encd[:chunk], params), 20)
    with torch.no_grad():
        module_ms = cuda_ms(lambda: model(x, d), 3)
    moved = nbytes(encx, encd, params.wpack, params.bpack, out)
    mlp_bound = bound(2.0 * mlp_macs(cfg) * n, moved)
    print(f"forward MLP at {n} rows on {card}: max abs err rgb "
          f"{rgb_err:.3e} sigma {sig_err:.3e} (max |sigma| {sig_scale:.3e}); "
          f"{'; '.join(acts)} at {small} rows; bitwise repeatable; kernel "
          f"{ms:.3f} ms (bound share {mlp_bound['bound_ms'] / ms:.3f}; "
          f"{chunk_ms:.3f} ms at one validation chunk's {chunk} rows, host "
          f"{host_ms:.4f} ms per call), plain {plain_ms:.3f} ms, bf16 NeRF "
          f"module {module_ms:.3f} ms")
    print(ptxas_of(log, "nerf_mlp_kernel"))
    return dict(max_abs_err=max(rgb_err, sig_err), ms=ms, plain_ms=plain_ms,
                **mlp_bound), module_ms


def hier_config(cfg, **train):
    import dataclasses

    return cfg.replace(
        sampling=dataclasses.replace(cfg.sampling, strategy="hierarchical",
                                     n_samples=HIER_COARSE,
                                     n_fine=HIER_FINE),
        train=dataclasses.replace(cfg.train, **train))


def hier_render_slice(model, cfg, dev, card):
    """Phase 8: render_path with the hierarchical strategy, with and
    without the fused fine pass."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.data.synthetic import (SphereScene,
                                                 render_sphere_image)
    from fsnerf_tpu_torch.eval.metrics import psnr
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import volrend as kv
    from fsnerf_tpu_torch.render.renderer import render_path

    hcfg = hier_config(cfg)
    scene = SphereScene(n_imgs=1, hw=128)
    path = scene.path_poses[:3]
    gt = torch.as_tensor(np.stack([render_sphere_image(p, scene.hwf)[0]
                                   for p in path]))
    chunks = len(path)          # one 16,384-ray chunk per 128x128 frame
    for fused_on in (True, False):
        km.nerf_mlp.launches = kr.ray_march.launches = 0
        kv.volume_render_fused.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_fn = cli.make_render_model_fn(model, hcfg, device=dev)
        fused = (cli.make_fused_render_fn(model.state_dict(), hcfg,
                                          device=dev) if fused_on else None)
        frames, _ = render_path(
            model_fn, path, scene.hwf, scene.near, scene.far, device=dev,
            strategy="hierarchical", n_samples=HIER_COARSE, n_fine=HIER_FINE,
            white_bkgd=True, fused_render_fn=fused,
            composite_fn=cli.make_composite_fn(hcfg, dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"nerf_mlp": km.nerf_mlp.launches,
                    "ray_march": kr.ray_march.launches,
                    "volrend": kv.volume_render_fused.launches}
        want_march = 1 if fused_on else 0
        if launches["nerf_mlp"] == 0 or \
                (launches["ray_march"] > 0) != bool(want_march) or \
                launches["volrend"] != chunks * (2 - want_march):
            fail(f"hierarchical render (fused fine pass {fused_on}) "
                 f"launched {launches}")
        if frames.shape != (3, 128, 128, 3) or not np.isfinite(frames).all():
            fail(f"bad hierarchical frames: shape {frames.shape}")
        p = float(psnr(torch.as_tensor(frames), gt))
        print(f"hierarchical render slice (fused fine pass {fused_on}): 3 "
              f"frames 128x128, C {HIER_COARSE} + F {HIER_FINE}, launches "
              f"{launches}, {seconds:.3f} s, {3 * 128 * 128 / seconds:.0f} "
              f"rays/s end to end on {card} (first call included); PSNR "
              f"{p:.3f} vs ground truth (random weights)")


def hier_train_slice(cfg, dev, card):
    """Phase 9: train the hierarchical strategy, then evaluate the held-out
    views. Returns the launch counts of the run."""
    import dataclasses

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.config import DataConfig
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import volrend as kv
    from fsnerf_tpu_torch.train.loop import train

    tcfg = hier_config(cfg, n_iters=HIER_STEPS).replace(
        data=DataConfig(dataset="sphere", n_imgs=8, white_bkgd=True))
    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    held = cli.split_of(scene.holdout(n=3, seed=101))
    model = make_model(tcfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    base, _ = cli.evaluate_split(model, None, held, tcfg, device=dev)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    log = ListLogger()

    kr.ray_march.launches = km.nerf_mlp.launches = 0
    mt.mlp_train_fwd.launches = mt.mlp_train_bwd.launches = 0
    kv.volume_render_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(model, tcfg, pool, scene, logger=log, log_every=100)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, _ = cli.evaluate_split(model, state.grid, held, tcfg, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {"mlp_train_fwd": mt.mlp_train_fwd.launches,
                "mlp_train_bwd": mt.mlp_train_bwd.launches,
                "nerf_mlp": km.nerf_mlp.launches,
                "ray_march": kr.ray_march.launches,
                "volrend": kv.volume_render_fused.launches}
    plain_fine = tcfg.replace(model=dataclasses.replace(tcfg.model,
                                                        fused_render=False))
    unfused, _ = cli.evaluate_split(model, state.grid, held, plain_fine,
                                    device=dev)

    losses = [r["loss"] for r in log.records]
    print(f"hierarchical train slice on {card}: {state.step} steps in "
          f"{train_s:.3f} s, {state.step / train_s:.2f} steps/s, "
          f"{state.step * tcfg.train.batch_size / train_s:.0f} rays/s "
          f"(first call included); loss {losses[0]:.5f} at step "
          f"{log.records[0]['step']} -> {losses[-1]:.5f}; launches "
          f"{launches}")
    print(f"hierarchical held-out (3 views 128x128): PSNR {got['psnr']:.3f} "
          f"SSIM {got['ssim']:.4f} in {eval_s:.3f} s after training "
          f"(without the fused fine pass: PSNR {unfused['psnr']:.3f}); "
          f"untrained PSNR {base['psnr']:.3f} SSIM {base['ssim']:.4f}")
    steps = state.step
    if launches["mlp_train_fwd"] != 2 * steps or \
            launches["mlp_train_bwd"] != 2 * steps:
        fail(f"the hierarchical step did not run the train kernels for "
             f"both passes: {launches} over {steps} steps")
    if launches["nerf_mlp"] == 0 or launches["ray_march"] == 0 or \
            launches["volrend"] != len(held.poses):
        fail(f"the hierarchical eval did not launch every kernel (the "
             f"compositing kernel once per view's chunk): {launches}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"hierarchical training loss did not fall: {losses}")
    if got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
        fail(f"hierarchical held-out PSNR {got['psnr']:.3f} is not "
             f"{MIN_PSNR_GAIN_DB} dB above the untrained {base['psnr']:.3f}")
    if abs(unfused["psnr"] - got["psnr"]) > HIER_FUSED_PSNR_TOL_DB:
        fail(f"the fused fine pass ({got['psnr']:.3f} dB) and the forward "
             f"MLP's ({unfused['psnr']:.3f} dB) disagree")
    return launches


def module_routes(cfg, dev, march_padded, model=None, rows=TRAIN_ROWS,
                  reps=3):
    """Phase 14: the bf16 NeRF module (cuBLAS GEMMs) on each kernel's rows:
    the ray march's points + volume_render, and the train kernels' 196,608
    rows (`rows`) forward and backward, each over `reps` calls. Returns ms
    by kernel name."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.volrend import volume_render

    if model is None:
        model = make_model(cfg, torch.bfloat16,
                           torch.Generator().manual_seed(3), dev)
    x, dirs, t, deltas, mask = march_padded
    with torch.no_grad():
        def march():
            out = model(x, dirs[:, None, :].expand(x.shape)).float()
            volume_render(out[..., 3], out[..., :3], t, deltas, mask > 0)

        march_ms = cuda_ms(march, reps)
    g = torch.Generator(device=dev).manual_seed(4)
    xs = torch.rand((rows, 3), generator=g, device=dev) * 3.0 - 1.5
    ds = torch.nn.functional.normalize(
        torch.randn((rows, 3), generator=g, device=dev), dim=-1)
    fwd_ms = cuda_ms(lambda: model(xs, ds), reps)
    out = model(xs, ds).float()
    dout = torch.full_like(out, 1.0 / out.numel())
    params = list(model.parameters())
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, params, dout,
                                                 retain_graph=True), reps)
    return {"ray_march": march_ms, "mlp_train_fwd": fwd_ms,
            "mlp_train_bwd": bwd_ms}


def sinerf_config(cfg, **train):
    import dataclasses

    return cfg.replace(
        model=dataclasses.replace(cfg.model, model="sinerf"),
        train=dataclasses.replace(cfg.train, **train))


def siren_macs(L: int, W: int) -> int:
    """Multiply-adds of one SiNeRF MLP row (raw 3-wide inputs, unpadded):
    the trunk, the sigma head, feat and the rgb head."""
    Wh = W // 2
    return 3 * W + (L - 1) * W * W + W * Wh + Wh + W * W + (W + 3) * Wh + \
        Wh * 3


def siren_bwd_macs(L: int, W: int) -> int:
    """Multiply-adds of one row of the SIREN backward from saved
    activations: the heads' recompute and their weight gradients, the
    heads' and the trunk's input cotangents down to layer 1, and the
    trunk's weight gradients."""
    Wh = W // 2
    heads = W * Wh + Wh + W * W + (W + 3) * Wh + Wh * 3
    dx = Wh * W + W * W + Wh * W + Wh + 3 * Wh + (L - 1) * W * W
    return 2 * heads + dx + 3 * W + (L - 1) * W * W


def siren_kernels(cfg, dev, card, log):
    """Phase 10: the SIREN train kernels vs their plain versions at full
    width, both backward modes, the device time of each of the saved
    mode's backward launches and ptxas's lines for the two row passes.
    Returns the report's numbers of each."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    scfg = sinerf_config(cfg)
    L, W = scfg.model.n_layers, scfg.model.d_filter
    model = make_model(scfg, torch.bfloat16,
                       torch.Generator().manual_seed(3), dev)
    params = ks.prep_siren_params(model.state_dict(), L,
                                  with_transposed=True)
    g = torch.Generator(device=dev).manual_seed(4)
    n = TRAIN_ROWS
    x = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    target = torch.cat([torch.rand((n, 3), generator=g, device=dev),
                        torch.zeros((n, 1), device=dev)], dim=-1)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    out, acts = ks.siren_mlp_fwd(xp, dp, params, save_acts=True)
    primal, _ = ks.siren_mlp_fwd(xp, dp, params)
    ref, ref_acts = ks.siren_mlp_fwd_reference(xp, dp, params, True)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all() or not torch.equal(out, primal):
        fail("SIREN forward: not finite, or saving changed the output")
    rgb_err = float((out[:, :3] - ref[:, :3]).abs().max())
    sig_err = float((out[:, 3] - ref[:, 3]).abs().max())
    sig_scale = float(ref[:, 3].abs().max()) + 1e-9
    if rgb_err > MLP_RGB_TOL or sig_err / sig_scale > MLP_SIGMA_TOL:
        fail(f"SIREN forward vs plain: rgb err {rgb_err:.3e}, sigma err "
             f"{sig_err:.3e} of max {sig_scale:.3e}")
    dout = (2.0 * (ref - target) / ref.numel()).contiguous()
    runs = {}
    for mode, a, plain_a in (("saved", acts, ref_acts),
                             ("recompute", None, None)):
        got = ks.siren_mlp_bwd(xp, dp, dout, params, a)
        again = ks.siren_mlp_bwd(xp, dp, dout, params, a)
        plain = ks.siren_mlp_bwd_reference(xp, dp, dout, params, plain_a)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            fail(f"SIREN backward ({mode}): two kernel runs differ")
        runs[mode] = got
        runs[mode + " plain"] = plain
    lay = params.layout
    worst = {}
    grad_abs = 0.0
    for name, got_k, want_k in (("saved", "saved", "saved plain"),
                                ("recompute", "recompute",
                                 "recompute plain"),
                                ("saved vs recompute", "saved",
                                 "recompute")):
        rel = ("", 0.0)
        for pname, gk, gp in zip(lay.param_names,
                                 lay.grads_from_packed(*runs[got_k]),
                                 lay.grads_from_packed(*runs[want_k])):
            abs_err = float((gk - gp).abs().max())
            r = abs_err / (float(gp.abs().max()) + 1e-30)
            if got_k != "saved" or want_k != "recompute":
                grad_abs = max(grad_abs, abs_err)
            if r > rel[1]:
                rel = (pname, r)
        worst[name] = rel
        if rel[1] > GRAD_TOL:
            fail(f"SIREN backward, {name}: {rel[0]} off by {rel[1]:.3e} of "
                 "its max")

    fwd_ms, fwd_plain_ms = in_turns(
        lambda: ks.siren_mlp_fwd_reference(xp, dp, params, True),
        lambda: ks.siren_mlp_fwd(xp, dp, params, True))
    fwd_nosave_ms = cuda_ms(lambda: ks.siren_mlp_fwd(xp, dp, params), 10)
    fwd_host_ms = host_ms_per_call(
        lambda: ks.siren_mlp_fwd(xp, dp, params, True))
    bwd_ms, bwd_plain_ms = in_turns(
        lambda: ks.siren_mlp_bwd_reference(xp, dp, dout, params, ref_acts),
        lambda: ks.siren_mlp_bwd(xp, dp, dout, params, acts))
    rec_ms = cuda_ms(lambda: ks.siren_mlp_bwd(xp, dp, dout, params, None),
                     10)
    parts, host_ms = kernel_split_ms(
        lambda: ks.siren_mlp_bwd(xp, dp, dout, params, acts),
        SIREN_BWD_PARTS)
    weights = (params.wpack, params.bpack, params.alphas)
    fwd_bound = bound(2.0 * siren_macs(L, W) * n,
                      nbytes(xp, dp, *weights, out, acts))
    bwd_bound = bound(2.0 * siren_bwd_macs(L, W) * n,
                      nbytes(xp, dp, dout, acts, *weights, params.wtpack,
                             *runs["saved"]))
    module_fwd_ms = cuda_ms(lambda: model(x, d), 3)
    m_out = model(x, d).float()
    m_params = list(model.parameters())
    module_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        m_out, m_params, torch.full_like(m_out, 1.0 / m_out.numel()),
        retain_graph=True), 3)
    print(f"SIREN kernels at {n} rows on {card}: forward max abs err rgb "
          f"{rgb_err:.3e} sigma {sig_err:.3e} (max |sigma| {sig_scale:.3e}); "
          "gradients worst " + ", ".join(
              f"{k} {v[0]} at {v[1]:.3e}" for k, v in worst.items())
          + f" of its max, max abs err {grad_abs:.3e}; bitwise repeatable "
          f"in each mode; forward {fwd_ms:.3f} ms (plain {fwd_plain_ms:.3f};"
          f" without acts {fwd_nosave_ms:.3f} ms; host {fwd_host_ms:.4f} ms "
          f"per call; bound share "
          f"{fwd_bound['bound_ms'] / fwd_ms:.3f}),"
          f" backward saved {bwd_ms:.3f} ms (plain {bwd_plain_ms:.3f}), "
          f"recompute {rec_ms:.3f} ms; bf16 SiNeRF module forward "
          f"{module_fwd_ms:.3f} ms, its autograd backward "
          f"{module_bwd_ms:.3f} ms")
    print("SIREN backward's launches (profiler, saved activations): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f"; host {host_ms:.4f} ms per call")
    print(ptxas_of(log, "siren_fwd_ws_kernel"))
    print(ptxas_of(log, "siren_fwd_kernel"))
    print(ptxas_of(log, "siren_bwd_rows_ws_kernel"))
    print(ptxas_of(log, "siren_bwd_rows_kernel"))
    return (dict(max_abs_err=max(rgb_err, sig_err), ms=fwd_ms,
                 plain_ms=fwd_plain_ms, **fwd_bound),
            dict(max_abs_err=grad_abs, ms=bwd_ms, plain_ms=bwd_plain_ms,
                 parts_ms=parts, **bwd_bound),
            {"siren_mlp_fwd": module_fwd_ms, "siren_mlp_bwd": module_bwd_ms})


def siren_march(cfg, dev, card, log):
    """Phase 11: the SIREN ray march vs its plain version on a held-out
    128x128 view, normal and saturating, its kernel's name from the
    profiler, its host ms per call and ptxas's lines for it. Returns (the
    report's numbers, the bf16 SiNeRF module's time on the same
    points)."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.ops.volrend import volume_render

    scfg = sinerf_config(cfg)
    L, W = scfg.model.n_layers, scfg.model.d_filter
    model = make_model(scfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    split = cli.build_split("sphere", 1, 128, True, seed=1)
    grid = cli.rebuild_grid(model, scfg, split.aabb, dev)
    padded, bR, cs, eval_k = march_inputs(scfg, grid, split, dev)
    sd = model.state_dict()
    params = ks.prep_siren_params(sd, L, device=dev)
    eps = scfg.sampling.early_stop_eps
    normal = compare("SIREN normal", kr.siren_ray_march,
                     kr.siren_ray_march_reference, padded, params, bR, cs,
                     eps)
    hot_sd = dict(sd, **{"sigma_layers.1.bias": sd["sigma_layers.1.bias"]
                         + SATURATING_SIGMA_BIAS})
    hot = compare("SIREN early-exit", kr.siren_ray_march,
                  kr.siren_ray_march_reference, padded,
                  ks.prep_siren_params(hot_sd, L, device=dev), bR, cs, eps)
    if hot["executed"] >= normal["executed"]:
        fail("a saturating sigma bias did not make SIREN blocks exit early")
    host_ms = host_ms_per_call(
        lambda: kr.siren_ray_march(*padded, params, bR, cs, eps), 20)
    march_bound = bound(
        2.0 * siren_macs(L, W) * normal["executed"] * bR * cs,
        nbytes(*padded, params.wpack, params.bpack, params.alphas)
        + padded[0].shape[0] * (8 + 1 / bR) * 4)
    x, dirs, t, deltas, mask = padded
    with torch.no_grad():
        def module_march():
            out = model(x, dirs[:, None, :].expand(x.shape)).float()
            volume_render(out[..., 3], out[..., :3], t, deltas, mask > 0)

        module_ms = cuda_ms(module_march, 3)
    print(f"SIREN ray march at {x.shape[0]} rays x K {eval_k} on {card}: "
          f"early exit {hot['ms']:.3f} ms; host {host_ms:.4f} ms per call; "
          f"bound share {march_bound['bound_ms'] / normal['ms']:.3f}; bf16 "
          f"SiNeRF module + volume_render {module_ms:.3f} ms")
    print(ptxas_of(log, "siren_march_kernel"))
    print(ptxas_of(log, "ray_march_kernel"))
    return dict(max_abs_err=max(normal["max_abs_err"], hot["max_abs_err"]),
                ms=normal["ms"], plain_ms=normal["plain_ms"],
                **march_bound), module_ms


def siren_train_slice(cfg, dev, card):
    """Phase 12: train SiNeRF, then render the held-out views through the
    SIREN ray march. Returns the launch counts of the run."""
    import dataclasses

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.config import DataConfig
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.train.loop import train

    tcfg = sinerf_config(cfg, n_iters=SIREN_STEPS).replace(
        data=DataConfig(dataset="sphere", n_imgs=8, white_bkgd=True))
    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    held = cli.split_of(scene.holdout(n=3, seed=101))
    model = make_model(tcfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    base, _ = cli.evaluate_split(
        model, og.conservative(cli.rebuild_grid(model, tcfg, scene.aabb,
                                                dev)), held, tcfg, device=dev)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    log = ListLogger()

    kr.siren_ray_march.launches = 0
    ks.siren_mlp_fwd.launches = ks.siren_mlp_bwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(model, tcfg, pool, scene, logger=log, log_every=100)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, _ = cli.evaluate_split(model, og.conservative(state.grid), held,
                                tcfg, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {"siren_mlp_fwd": ks.siren_mlp_fwd.launches,
                "siren_mlp_bwd": ks.siren_mlp_bwd.launches,
                "siren_ray_march": kr.siren_ray_march.launches}
    losses = [r["loss"] for r in log.records]
    print(f"SiNeRF train slice on {card}: {state.step} steps in "
          f"{train_s:.3f} s, {state.step / train_s:.2f} steps/s, "
          f"{state.step * tcfg.train.batch_size / train_s:.0f} rays/s "
          f"(first call included); loss {losses[0]:.5f} at step "
          f"{log.records[0]['step']} -> {losses[-1]:.5f}; final K "
          f"{log.records[-1]['n_compact']:.0f}, occupancy "
          f"{log.records[-1]['occupancy']:.4f}; launches {launches}")
    print(f"SiNeRF held-out (3 views 128x128): PSNR {got['psnr']:.3f} SSIM "
          f"{got['ssim']:.4f} eval K {got['eval_k']} in {eval_s:.3f} s after "
          f"training; untrained PSNR {base['psnr']:.3f} SSIM "
          f"{base['ssim']:.4f}")
    steps = state.step
    if launches["siren_mlp_fwd"] != steps or \
            launches["siren_mlp_bwd"] != steps:
        fail(f"the SiNeRF step did not run the SIREN train kernels once per "
             f"step: {launches} over {steps} steps")
    if launches["siren_ray_march"] == 0:
        fail(f"the SiNeRF eval did not launch the SIREN ray march: "
             f"{launches}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"SiNeRF training loss did not fall: {losses}")
    if got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
        fail(f"SiNeRF held-out PSNR {got['psnr']:.3f} is not "
             f"{MIN_PSNR_GAIN_DB} dB above the untrained {base['psnr']:.3f}")
    return launches


def siren_hier_render_slice(cfg, dev, card):
    """Phase 13: render_path of a SiNeRF with the hierarchical strategy:
    the coarse pass on the SIREN forward kernel, the fine pass on the SIREN
    ray march."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.render.renderer import render_path

    hcfg = sinerf_config(hier_config(cfg))
    model = make_model(hcfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    scene = SphereScene(n_imgs=1, hw=128)

    ks.siren_mlp_fwd.launches = kr.siren_ray_march.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames, _ = render_path(
        cli.make_render_model_fn(model, hcfg, device=dev),
        scene.path_poses[:3], scene.hwf, scene.near, scene.far, device=dev,
        strategy="hierarchical", n_samples=HIER_COARSE, n_fine=HIER_FINE,
        white_bkgd=True,
        fused_render_fn=cli.make_fused_render_fn(model.state_dict(), hcfg,
                                                 device=dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"siren_mlp_fwd": ks.siren_mlp_fwd.launches,
                "siren_ray_march": kr.siren_ray_march.launches}
    if min(launches.values()) == 0:
        fail(f"the SiNeRF hierarchical render launched {launches}")
    if frames.shape != (3, 128, 128, 3) or not np.isfinite(frames).all():
        fail(f"bad SiNeRF hierarchical frames: shape {frames.shape}")
    print(f"SiNeRF hierarchical render slice: 3 frames 128x128, C "
          f"{HIER_COARSE} + F {HIER_FINE}, launches {launches}, "
          f"{seconds:.3f} s, {3 * 128 * 128 / seconds:.0f} rays/s end to end "
          f"on {card} (first call included)")


def density_kernel(cfg, dev, card, log):
    """Phase 14: the density kernel vs its plain version at full width, and
    the grid refresh through it and through the bf16 module; ptxas's lines
    for it from the build's `log`. Returns (the report's numbers, the
    module's density ms on the same rows)."""
    from fsnerf_tpu_torch.core.encoding import freq_mask, positional_encoding
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.train.step import make_density_fn

    s = cfg.sampling
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(6), dev)
    grid = og.create(np.array([-1.5] * 3 + [1.5] * 3, np.float32),
                     s.grid_resolution, device=dev)
    n, res = grid.n_cells, grid.resolution
    k = n // s.update_parts
    # mid-anneal: bands 1-5 open, the sixth at a third
    pm = freq_mask(cfg.encoder.n_freqs, 400, FEWSHOT_ANNEAL, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.arange(n, device=dev)
    x_all = og._cell_positions(idx, grid.base_aabb, res)
    x_part = og._cell_positions(idx[k:2 * k], grid.base_aabb, res,
                                torch.rand((k, 3), generator=g, device=dev))
    params = km.prep_params(model.state_dict(), cfg.model.n_layers,
                            cfg.model.skip)          # packed on the card
    if params.wpack.device != x_all.device:
        fail("the density weights were not packed on the card")

    def encode(x):
        return km.pad_features(positional_encoding(x, cfg.encoder.n_freqs,
                                                   True, pm),
                               params.d_enc_pad)

    with torch.no_grad():
        encx, encq = encode(x_all), encode(x_part)
    errs = {}
    for name, e, act in (("all cells", encx, "none"),
                         ("jittered quarter", encq, "none"),
                         ("relu", encx[:65_573], "relu"),
                         ("trunc_exp", encx[:65_573], "trunc_exp")):
        got = km.nerf_density(e, params, act)
        again = km.nerf_density(e, params, act)
        ref = km.nerf_density_reference(e, params, act)
        torch.cuda.synchronize()
        if got.shape != (e.shape[0],) or not torch.isfinite(got).all():
            fail(f"density kernel ({name}): not finite or misshapen")
        if not torch.equal(got, again):
            fail(f"density kernel ({name}): two runs differ")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max()) + 1e-9
        if err / scale > DENSITY_SIGMA_TOL or (act != "none"
                                               and (got < 0).any()):
            fail(f"density kernel ({name}) vs plain: err {err:.3e} of max "
                 f"{scale:.3e}")
        errs[name] = (err, err / scale)
    ms, plain_ms = in_turns(lambda: km.nerf_density_reference(encx, params),
                            lambda: km.nerf_density(encx, params))
    chunk = encx[:og._EVAL_CHUNK]           # one og.update launch's rows
    chunk_ms = cuda_ms(lambda: km.nerf_density(chunk, params), 20)
    host_ms = host_ms_per_call(lambda: km.nerf_density(chunk, params))
    chunk_bound = bound(2.0 * density_macs(cfg) * chunk.shape[0],
                        nbytes(chunk, params.wpack, params.bpack)
                        + 4 * chunk.shape[0])
    with torch.no_grad():
        module_ms = cuda_ms(lambda: model(x_all, pos_mask=pm), 3)

        def module_fn(x):
            return model(x, pos_mask=pm)[..., 0]

        jit_all = [torch.rand((n, 3), generator=g, device=dev)]
        jit_part = [torch.rand((k, 3), generator=g, device=dev)]
        times, grids = {}, {}
        for route, make_fn in (
                ("density kernel", lambda: make_density_fn(model, cfg, pm,
                                                           dev)),
                ("bf16 module", lambda: module_fn)):
            for kind, step, jit in (("all cells", 0, jit_all),
                                    ("quarter", s.warmup_steps, jit_part)):
                def refresh():
                    return og.update(grid, make_fn(), step,
                                     render_step_size=s.render_step_size,
                                     occ_thre=s.occ_thre,
                                     ema_decay=s.ema_decay,
                                     warmup_steps=s.warmup_steps,
                                     update_parts=s.update_parts,
                                     update_interval=s.update_interval,
                                     jitter=jit)

                grids[route, kind] = refresh()
                times[route, kind] = cuda_ms(refresh, 3)
    agree = float((grids["density kernel", "all cells"].binaries
                   == grids["bf16 module", "all cells"].binaries)
                  .float().mean())
    if agree < 0.98:
        fail(f"the two refresh routes agree on {agree:.4f} of the cells")
    print(f"density kernel at {n} cell centres of a res-{res} grid on "
          f"{card}: " + "; ".join(f"{k} err {v[0]:.3e} ({v[1]:.3e} of max)"
                                  for k, v in errs.items())
          + f"; bitwise repeatable; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bf16 module density {module_ms:.3f} ms; at {chunk.shape[0]} "
          f"rows (one og.update launch) {chunk_ms:.3f} ms, bound share "
          f"{chunk_bound['bound_ms'] / chunk_ms:.3f}, host {host_ms:.4f} ms "
          f"per call")
    print(ptxas_of(log, "nerf_density_kernel"))
    print(f"grid refresh on {card}: " + ", ".join(
        f"{r} {kind} {t:.3f} ms" for (r, kind), t in times.items())
          + f"; all-cell binaries of the two routes agree on {agree:.5f}")
    out = torch.empty(n, device=dev)
    return (dict(max_abs_err=max(v[0] for v in errs.values()), ms=ms,
                 plain_ms=plain_ms,
                 **bound(2.0 * density_macs(cfg) * n,
                         nbytes(encx, params.wpack, params.bpack, out))),
            module_ms, times)


def composite_check(name, got, again, ref):
    """The compositing kernel's outputs vs volume_render's: bitwise
    repeatable, and within VOLREND_RTOL of the value plus VOLREND_ATOL.
    Returns the max abs error."""
    worst, excess = 0.0, {}
    for key in ("rgb", "opacity", "depth", "weights", "trans_final"):
        if not torch.equal(got[key], again[key]):
            fail(f"compositing kernel ({name}): two runs differ in {key}")
        err = (got[key] - ref[key]).abs()
        worst = max(worst, float(err.max()))
        excess[key] = float((err / (VOLREND_ATOL + VOLREND_RTOL
                                    * ref[key].abs())).max())
    if max(excess.values()) > 1.0:
        fail(f"compositing kernel ({name}) vs volume_render: {excess}")
    print(f"compositing kernel ({name}): max abs err {worst:.3e}; of rtol "
          f"{VOLREND_RTOL} atol {VOLREND_ATOL}: " + ", ".join(
              f"{k} {v:.3f}" for k, v in excess.items()))
    return worst


def volrend_kernel(cfg, dev, card):
    """Phase 15: the compositing kernel vs volume_render at the coarse
    pass's and the validation's shapes. Returns the report's numbers (the
    coarse pass)."""
    import itertools

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.rays import get_rays
    from fsnerf_tpu_torch.ops.kernels import volrend as kv
    from fsnerf_tpu_torch.ops.sampling import (compact_samples_uniform,
                                               sample_points,
                                               stratified_samples)
    from fsnerf_tpu_torch.ops.volrend import volume_render
    from fsnerf_tpu_torch.render.renderer import _masked_lattice

    s = cfg.sampling
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(8), dev)
    model_fn = cli.make_render_model_fn(model, cfg, device=dev)
    held = cli.build_split("sphere", 1, 128, True, seed=101)
    pose = torch.as_tensor(held.poses[0], dtype=torch.float32, device=dev)
    ro, rd = (a.reshape(-1, 3) for a in get_rays(pose, held.hwf))
    R = ro.shape[0]
    grid = cli.rebuild_grid(model, cfg, held.aabb, dev)
    with torch.no_grad():
        t_c, d_c = stratified_samples(ro, rd, held.near, held.far,
                                      HIER_COARSE)
        x_c = sample_points(ro, rd, t_c)
        coarse = (model_fn(x_c, rd[:, None, :].expand(x_c.shape)).float(),
                  t_c, d_c, None)
        t_mid, deltas, mask, _ = _masked_lattice(
            ro, rd, grid, s.n_samples, None, s.render_step_size,
            s.early_stop_eps, 1)
        t_k, d_k, m_k = compact_samples_uniform(t_mid, deltas[:, 0], mask,
                                                s.n_compact)
        m_k[:R // 8] = False                    # fully masked rays
        x_k = sample_points(ro, rd, t_k)
        val = (model_fn(x_k, rd[:, None, :].expand(x_k.shape)).float(), t_k,
               d_k, m_k)
    report = None
    for name, (out4, tv, dl, m) in (("coarse pass, no mask", coarse),
                                    ("validation K, masked", val)):
        S = tv.shape[1]
        args = (out4[..., 3], out4[..., :3], tv, dl, m, 1.0)
        got = kv.volume_render_fused(*args)
        again = kv.volume_render_fused(*args)
        ref = volume_render(*args)
        torch.cuda.synchronize()
        err = composite_check(f"{R} rays x {S}, {name}", got, again, ref)
        # four copies of the inputs exceed the 50 MB L2 cache, so each
        # timed call reads its inputs from device memory
        copies = itertools.cycle([tuple(None if a is None else a.clone()
                                        for a in (out4, tv, dl, m))
                                  for _ in range(4)])

        white = torch.ones((), device=dev)  # no host copy in graph capture

        def call(fn):
            o4, tv_, dl_, m_ = next(copies)
            fn(o4[..., 3], o4[..., :3], tv_, dl_, m_, white)

        # eager calls time the host (the wrapper's checks take longer than
        # the kernel); the device time comes from CUDA graphs of 20 calls
        eager_ms, eager_plain_ms = in_turns(
            lambda: call(volume_render), lambda: call(kv.volume_render_fused),
            plain_reps=10, kernel_reps=20)
        calls = 20
        ms, plain_ms = (t / calls for t in in_turns(
            graphed(lambda: call(volume_render), calls),
            graphed(lambda: call(kv.volume_render_fused), calls)))
        moved = nbytes(out4, tv, dl, got["weights"]) + R * 8 * 4 + (
            0 if m is None else m.numel())
        # per sample: od, its cumsum, the exclusive subtract, two exp, 1 -
        # exp, w, and the five sums' multiply-adds: ~17 float32 operations
        b = bound(17.0 * R * S, moved, PEAK_F32_FLOPS)
        print(f"compositing kernel at {R} rays x {S} ({name}) on {card}: "
              f"device time from CUDA graphs: kernel {ms:.4f} ms, "
              f"volume_render {plain_ms:.4f} ms; eager calls (host-bound) "
              f"{eager_ms:.4f} / {eager_plain_ms:.4f} ms; bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {moved} bytes)")
        if report is None:
            report = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)
    return report


def fewshot_config(cfg):
    import dataclasses

    from fsnerf_tpu_torch.config import DataConfig

    return cfg.replace(
        encoder=dataclasses.replace(cfg.encoder,
                                    freq_reg_end=FEWSHOT_ANNEAL),
        data=DataConfig(dataset="lattice", n_imgs=3, white_bkgd=True),
        train=dataclasses.replace(
            cfg.train, n_iters=FEWSHOT_STEPS, occ_a=0.003, occ_b=2.0,
            occ_func="exp", beta=1.0, ao=1e-6, val=True,
            val_rate=FEWSHOT_VAL, ckpt_every=FEWSHOT_CKPT))


def fewshot_slice(cfg, dev, card):
    """Phase 16: the few-shot recipe's training, its validations and
    checkpoint, the held-out eval, and the resumed run. Returns the launch
    counts of the uninterrupted run."""
    import os
    import tempfile

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import LatticeScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import volrend as kv
    from fsnerf_tpu_torch.train.loop import train
    from fsnerf_tpu_torch.train.step import init_state, make_optimizer
    from fsnerf_tpu_torch.utils.checkpoint import Checkpointer

    tcfg = fewshot_config(cfg)
    scene = LatticeScene(n_imgs=3, hw=128, white_bkgd=True)
    held = cli.split_of(scene.holdout(n=3, seed=101))
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)

    def fresh_model():
        return make_model(tcfg, torch.bfloat16,
                          torch.Generator().manual_seed(0), dev)

    model = fresh_model()
    base, _ = cli.evaluate_split(
        model, og.conservative(cli.rebuild_grid(model, tcfg, scene.aabb,
                                                dev)), held, tcfg, device=dev)
    log = ListLogger()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Checkpointer(os.path.join(tmp, "ckpt"))
        mt.mlp_train_fwd.launches = mt.mlp_train_bwd.launches = 0
        km.nerf_density.launches = kv.volume_render_fused.launches = 0
        km.nerf_mlp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train(model, tcfg, pool, scene, logger=log, log_every=100,
                      checkpointer=ckpt,
                      val_fn=cli.make_val_fn(model, tcfg, held, dev))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {"mlp_train_fwd": mt.mlp_train_fwd.launches,
                    "mlp_train_bwd": mt.mlp_train_bwd.launches,
                    "nerf_density": km.nerf_density.launches,
                    "volrend": kv.volume_render_fused.launches,
                    "nerf_mlp": km.nerf_mlp.launches}
        saved = ckpt.steps()
        # resume from the step-1,000 checkpoint and run to the end again
        os.remove(ckpt.path(FEWSHOT_STEPS))
        model2 = fresh_model()
        resumed = ckpt.restore(init_state(model2, tcfg,
                                          make_optimizer(tcfg, model2),
                                          scene.aabb, dev))
        restored_step = resumed.step
        resumed = train(model2, tcfg, pool, scene, state=resumed,
                        log_every=100, checkpointer=ckpt,
                        val_fn=cli.make_val_fn(model2, tcfg, held, dev))
        torch.cuda.synchronize()
    got, _ = cli.evaluate_split(model, og.conservative(state.grid), held,
                                tcfg, device=dev)
    torch.cuda.synchronize()

    steps = state.step
    train_recs = [r for r in log.records if "loss" in r]
    val_recs = [r for r in log.records if "val_psnr" in r]
    losses = [r["loss"] for r in train_recs]
    occ = [(r["step"], r["occupancy"]) for r in train_recs]
    val_chunks = -(-held.hwf[0] * held.hwf[1] // (2 * tcfg.train.batch_size))
    want = {"mlp_train_fwd": steps, "mlp_train_bwd": steps,
            "nerf_density": refresh_launches(tcfg, state.grid.n_cells,
                                             steps),
            "volrend": len(val_recs) * val_chunks,
            "nerf_mlp": len(val_recs) * val_chunks}
    print(f"few-shot train slice on {card}: {steps} steps in {train_s:.3f} "
          f"s, {steps / train_s:.2f} steps/s (validations and the "
          f"checkpoint included); loss {losses[0]:.5f} at step "
          f"{train_recs[0]['step']} -> {losses[-1]:.5f}; occupancy by step "
          f"{occ}; validation PSNR "
          + ", ".join(f"{r['step']}: {r['val_psnr']:.3f}" for r in val_recs)
          + f"; launches {launches}")
    print(f"few-shot held-out (3 views 128x128): PSNR {got['psnr']:.3f} SSIM "
          f"{got['ssim']:.4f} eval K {got['eval_k']} after training; "
          f"untrained PSNR {base['psnr']:.3f} SSIM {base['ssim']:.4f}")
    if launches["nerf_mlp"] == 0:
        fail("the few-shot validations never launched the forward MLP "
             "kernel")
    if launches != want:
        fail(f"the few-shot slice launched {launches}, not {want}")
    if [r["step"] for r in val_recs] != list(range(
            FEWSHOT_VAL, steps + 1, FEWSHOT_VAL)) or \
            not all(math.isfinite(r["val_psnr"]) for r in val_recs):
        fail(f"the validations were not run every {FEWSHOT_VAL} steps: "
             f"{val_recs}")
    # a logged step reads the grid of the last refresh before it (every
    # 16 steps here): held through 700, released by 800
    if any(v != 1.0 for k, v in occ if k <= FEWSHOT_ANNEAL - 50) or \
            any(v >= 1.0 for k, v in occ if k >= FEWSHOT_ANNEAL + 50):
        fail(f"the culling hold did not hold to step {FEWSHOT_ANNEAL} and "
             f"release after it: {occ}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        fail(f"few-shot training loss did not fall: {losses}")
    if got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
        fail(f"few-shot held-out PSNR {got['psnr']:.3f} is not "
             f"{MIN_PSNR_GAIN_DB} dB above the untrained {base['psnr']:.3f}")

    if saved != [FEWSHOT_CKPT, FEWSHOT_STEPS] or \
            restored_step != FEWSHOT_CKPT:
        fail(f"checkpoints {saved}, restored at {restored_step}: not at "
             f"{FEWSHOT_CKPT} and {FEWSHOT_STEPS}")
    grid_keys = ("occs", "binaries", "thre", "occ_q", "od_q")
    diffs = {name: float((a.detach() - b.detach()).abs().max())
             for (name, a), b in zip(model.named_parameters(),
                                     model2.parameters())}
    diffs.update({f"grid.{k}": float((getattr(state.grid, k).float()
                                      - getattr(resumed.grid, k).float())
                                     .abs().max()) for k in grid_keys})
    bitwise = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                    model2.parameters())) \
        and all(torch.equal(getattr(state.grid, k), getattr(resumed.grid, k))
                for k in grid_keys)
    print(f"few-shot resume: step {restored_step} checkpoint -> "
          f"{resumed.step}: weights and grid "
          + ("bitwise equal to the uninterrupted run's" if bitwise else
             f"differ: largest {max(diffs.items(), key=lambda kv: kv[1])}"))
    if not bitwise:
        fail(f"the resumed run differs from the uninterrupted one: {diffs}")
    return launches


def run_cli(argv):
    """fsnerf_tpu_torch.cli.main(argv), the command line's own entry
    point; its JSON line, which is echoed."""
    import io

    from fsnerf_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"cli.main({argv}) returned {rc}")
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"  cli: {line}")
    return json.loads(line)


def lattice_views(poses, hwf):
    """The lattice's rgb [N, H, W, 3] on black and hit mask [N, H, W] seen
    from `poses` (render_lattice_image, the port's numpy ray tracer, one
    view per thread)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from fsnerf_tpu_torch.data.synthetic import (make_lattice_boxes,
                                                 render_lattice_image)

    boxes = make_lattice_boxes(7)
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        out = list(ex.map(lambda pose: render_lattice_image(
            pose, hwf, boxes, white_bkgd=False), poses))
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))


def write_blender_scene(root: str) -> str:
    """BLENDER_VIEWS lattice views on the upper hemisphere at radius
    4.0311289 as a Blender scene (transforms_train.json, RGBA PNGs written
    by the port's writer, alpha where a ray hits); returns its name."""
    import os

    from fsnerf_tpu_torch.data.poses import pose_from_spherical
    from fsnerf_tpu_torch.native import write_png
    from fsnerf_tpu_torch.render.renderer import to8b

    scene_dir = os.path.join(root, "synthetic", "lattice")
    os.makedirs(os.path.join(scene_dir, "train"))
    rng = np.random.default_rng(0)
    n = BLENDER_VIEWS
    thetas = rng.uniform(20.0, 80.0, n)
    phis = np.linspace(0.0, 360.0, n, endpoint=False) + rng.uniform(
        0.0, 360.0 / n, n)
    poses = [pose_from_spherical(4.0311289, t, p)
             for t, p in zip(thetas, phis)]
    hw = BLENDER_HW
    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    rgb, depth = lattice_views(poses, (hw, hw, focal))
    frames = []
    for i, pose in enumerate(poses):
        alpha = np.where(depth[i] > 0, 255, 0).astype(np.uint8)
        write_png(os.path.join(scene_dir, "train", f"r_{i}.png"),
                  np.concatenate([to8b(rgb[i]), alpha[..., None]], -1))
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": pose.tolist()})
    with open(os.path.join(scene_dir, "transforms_train.json"), "w") as fh:
        json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, fh)
    return "lattice"


def write_llff_scene(root: str, name: str = "lattice", jpeg=False) -> str:
    """LLFF_VIEWS forward-facing lattice views (cameras on a plane 4.5
    above it, looking down, tilted up to ~3 degrees) as an LLFF scene:
    poses_bounds.npy in the LLFF column order with each view's hit-depth
    bounds and the full-size hwf column, images_8/ PNGs (the port's
    writer) or, with `jpeg`, JPEGs (PIL, quality 95, 4:2:0); returns
    `name`, the scene's directory under root/llff."""
    import os

    from fsnerf_tpu_torch.native import write_png
    from fsnerf_tpu_torch.render.renderer import to8b

    scene_dir = os.path.join(root, "llff", name)
    os.makedirs(os.path.join(scene_dir, "images_8"))
    rng = np.random.default_rng(1)
    poses = []
    for _ in range(LLFF_VIEWS):
        w = 0.05 * rng.normal(size=3)
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                      [-w[1], w[0], 0]]) / th
        rot = np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = rot
        pose[:3, 3] = [*rng.uniform(-0.4, 0.4, 2), 4.5]
        poses.append(pose)
    hwf = (LLFF_H, LLFF_W, LLFF_FOCAL)
    rgb, depth = lattice_views(poses, hwf)
    rows = []
    for i, pose in enumerate(poses):
        path = os.path.join(scene_dir, "images_8", f"im_{i:03d}")
        if jpeg:
            from PIL import Image
            Image.fromarray(to8b(rgb[i])).save(path + ".jpg", quality=95,
                                               subsampling=2)
        else:
            write_png(path + ".png", to8b(rgb[i]))
        c2w = np.zeros((3, 5), np.float32)
        # LLFF [down, right, back] columns of the NeRF [right, up, back]
        c2w[:, 0], c2w[:, 1] = -pose[:3, 1], pose[:3, 0]
        c2w[:, 2], c2w[:, 3] = pose[:3, 2], pose[:3, 3]
        c2w[:, 4] = [LLFF_H * 8, LLFF_W * 8, LLFF_FOCAL * 8]
        hit = depth[i][depth[i] > 0]
        rows.append(np.concatenate([c2w.ravel(), [hit.min(), hit.max()]]))
    np.save(os.path.join(scene_dir, "poses_bounds.npy"), np.stack(rows))
    return name


@contextlib.contextmanager
def short_paths():
    """The loaders' camera paths cut to BLENDER_PATH_FRAMES and
    LLFF_PATH_FRAMES frames while the data slices run."""
    from fsnerf_tpu_torch.data import blender, llff

    orbit, spiral = blender.spherical_path, llff.spiral_path
    blender.spherical_path = lambda radius, theta, frames: orbit(
        radius, theta, BLENDER_PATH_FRAMES)
    llff.spiral_path = lambda poses, bounds, **kw: spiral(
        poses, bounds, n_views=LLFF_PATH_FRAMES, **kw)
    try:
        yield
    finally:
        blender.spherical_path, llff.spiral_path = orbit, spiral


def frames_of(video_dir: str) -> dict:
    import os

    return {n: open(os.path.join(video_dir, n), "rb").read()
            for n in sorted(os.listdir(video_dir))}


def data_slice(name, flags, out_dir, want_views, want_frames, card,
               train_flags=()):
    """The command line's whole flow on a synthesized scene: the untrained
    weights' val PSNR (render only, --debug: no run directory), then
    training, val and test evaluation, final_metrics.json, the checkpoint
    and the camera path's frames in the run directory under out_dir, the
    launch counts of kernels 5, 6, 4 and 1 read around that run, and
    --render_only from the checkpoint, which must write the same frames.
    `train_flags` go to the training run only. Returns (the training run's
    JSON line, its launch counts, the untrained val PSNR)."""
    import os

    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    from fsnerf_tpu_torch import cli

    base = run_cli(flags + ["--render_only", "--debug"])
    kr.ray_march.launches = km.nerf_density.launches = 0
    mt.mlp_train_fwd.launches = mt.mlp_train_bwd.launches = 0
    got = run_cli(flags + ["--out_dir", out_dir] + list(train_flags))
    torch.cuda.synchronize()
    launches = {"mlp_train_fwd": mt.mlp_train_fwd.launches,
                "mlp_train_bwd": mt.mlp_train_bwd.launches,
                "nerf_density": km.nerf_density.launches,
                "ray_march": kr.ray_march.launches}
    run = cli.run_dir(cli.config_from_args(flags + ["--out_dir", out_dir]))
    with open(os.path.join(run, "final_metrics.json")) as fh:
        final = json.load(fh)
    frames = frames_of(os.path.join(run, "video"))
    again = run_cli(flags + ["--out_dir", out_dir, "--render_only"])
    same = frames_of(os.path.join(run, "video")) == frames
    steps = got["steps"]
    print(f"{name} slice on {card}: views {got['views']}; data (decode, "
          f"split, pool) {got['data_seconds']:.3f} s; {steps} steps in "
          f"{got['train_seconds']:.3f} s, "
          f"{steps / got['train_seconds']:.2f} steps/s; val PSNR "
          f"{got['psnr']:.3f} SSIM {got['ssim']:.4f} (untrained "
          f"{base['psnr']:.3f}), test PSNR {got['test_psnr']:.3f} SSIM "
          f"{got['test_ssim']:.4f}; eval {got['eval_seconds_per_view']:.3f} "
          f"s per view; path {got['path_frames']} frames at "
          f"{got['path_frames_per_sec']:.3f} frames/s; launches {launches}; "
          f"render-only from step {again['restored_step']}: frames "
          + ("byte-equal" if same else "DIFFER"))
    if got["views"] != want_views:
        fail(f"{name}: splits {got['views']}, not {want_views}")
    if not all(k in final for k in ("psnr", "ssim", "test_psnr",
                                    "test_ssim")) or \
            final["lpips"] is not None:
        fail(f"{name}: final_metrics.json holds {final}")
    if min(launches.values()) == 0 or launches["mlp_train_fwd"] != steps \
            or launches["mlp_train_bwd"] != steps:
        fail(f"{name}: the run launched {launches} in {steps} steps")
    if got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
        fail(f"{name}: val PSNR {got['psnr']:.3f} is not {MIN_PSNR_GAIN_DB} "
             f"dB above the untrained {base['psnr']:.3f}")
    n = want_frames
    if got["path_frames"] != n or sorted(frames) != sorted(
            [f"rgb_{i:04d}.png" for i in range(n)]
            + [f"depth_{i:04d}.png" for i in range(n)]):
        fail(f"{name}: the path's frames on disk are {sorted(frames)[:4]}..."
             f" ({len(frames)} files), not {n} rgb and depth frames")
    if not same or again["restored_step"] != steps or \
            again["psnr"] != got["psnr"]:
        fail(f"{name}: --render_only from the checkpoint did not reproduce "
             f"the run's metrics and frames")
    return got, launches, base["psnr"]


def blender_slice(card, root):
    """Phase 17: the Blender-format slice through the command line, its
    training run with --export_render. Returns (its launches, the decode
    seconds, the arguments of phase 21c: the flags, the out_dir, the
    artifact's directory and the CLI's export seconds)."""
    import os

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.native import decode_images

    t0 = time.perf_counter()
    scene = write_blender_scene(root)
    synth_s = time.perf_counter() - t0
    files = [os.path.join(root, "synthetic", scene, "train", f"r_{i}.png")
             for i in range(BLENDER_VIEWS)]
    t0 = time.perf_counter()
    imgs = decode_images(files)
    decode_s = time.perf_counter() - t0
    print(f"blender scene: {BLENDER_VIEWS} views {BLENDER_HW}x{BLENDER_HW} "
          f"RGBA synthesized and written in {synth_s:.3f} s; decoded to "
          f"{list(imgs.shape)} float32 in {decode_s:.3f} s "
          f"({BLENDER_VIEWS / decode_s:.2f} images/s)")
    del imgs
    flags = ["--dataset", "synthetic", "--scene", scene, "--data_root", root,
             "--n_imgs", "8", "--white_bkgd", "--n_iters",
             str(BLENDER_STEPS)]
    n_held = int(0.15 * BLENDER_VIEWS)
    out_dir = os.path.join(root, "out_blender")
    art = os.path.join(root, "blender_artifact")
    got, launches, _ = data_slice(
        "blender", flags, out_dir,
        {"train": 8, "val": n_held, "test": n_held}, BLENDER_PATH_FRAMES,
        card, ["--export_render", art])
    if got.get("export_render") != art:
        fail(f"blender: the CLI did not export to {art}: {got}")
    bcfg = cli.config_from_args(flags)
    want = refresh_launches(bcfg, bcfg.sampling.grid_resolution ** 3,
                            got["steps"])
    if launches["nerf_density"] != want:
        fail(f"blender: the density kernel launched "
             f"{launches['nerf_density']} times, not {want}")
    return launches, decode_s, (flags, out_dir, art, got["export_seconds"])


def llff_slice(dev, card, root):
    """Phase 18: the LLFF-format slice through the command line (NDC rays,
    4 grid levels), then LLFF_GRAPH_STEPS steps graphed and eager from the
    same seeds, and kernels 1 and 4 against their plain versions on NDC
    samples of the 4-level grid. Returns (the CLI run's launches, its val
    PSNR)."""
    import dataclasses
    import os

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.encoding import positional_encoding
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import launch_counts
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.train.loop import train

    t0 = time.perf_counter()
    scene = write_llff_scene(root)
    print(f"llff scene: {LLFF_VIEWS} views {LLFF_W}x{LLFF_H} synthesized "
          f"and written in {time.perf_counter() - t0:.3f} s")
    flags = ["--dataset", "llff", "--scene", scene, "--data_root", root,
             "--n_imgs", "8", "--n_iters", str(LLFF_STEPS)]
    n_held = int(0.15 * LLFF_VIEWS)
    got, launches, _ = data_slice(
        "llff", flags, os.path.join(root, "out_llff"),
        {"train": 8, "val": n_held, "test": n_held}, LLFF_PATH_FRAMES, card)
    lcfg = cli.config_from_args(flags)
    s = lcfg.sampling
    per_refresh = -(-s.grid_resolution ** 3 // og._EVAL_CHUNK) * \
        s.grid_levels
    want = refresh_launches(lcfg, s.grid_resolution ** 3, got["steps"])
    if s.grid_levels != 4 or per_refresh != 32 or \
            launches["nerf_density"] != want:
        fail(f"llff: {s.grid_levels} levels, {per_refresh} density "
             f"launches per all-cell refresh, {launches['nerf_density']} "
             f"in all, not {want}")

    # graphed and eager from the same seeds, bitwise
    gcfg = lcfg.replace(train=dataclasses.replace(
        lcfg.train, n_iters=LLFF_GRAPH_STEPS))
    runs = {}
    for graphs in (None, False):
        _, (train_split, val_split, _), model, pool = cli.build_everything(
            gcfg, device=dev)
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = train(model, gcfg, pool, train_split, graphs=graphs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = launch_counts()
        runs[graphs] = (state, {k: after[k] - before[k] for k in after},
                        seconds)
    (g_state, g_launches, g_s), (e_state, e_launches, e_s) = \
        runs[None], runs[False]
    differ = state_diffs(g_state, e_state)
    if g_launches != e_launches:
        differ.append("launches")
    print(f"llff graphed vs eager on {card}: {LLFF_GRAPH_STEPS} steps, "
          f"graphed {LLFF_GRAPH_STEPS / g_s:.2f} steps/s, eager "
          f"{LLFF_GRAPH_STEPS / e_s:.2f} steps/s (first calls included); "
          f"density launches {g_launches['nerf_density']} "
          f"({per_refresh} per all-cell refresh of the "
          f"{s.grid_levels} levels); weights, Adam moments, grid, "
          f"generator and launches "
          + ("bitwise equal" if not differ else f"differ: {differ}"))
    if differ or g_launches["nerf_density"] != refresh_launches(
            gcfg, s.grid_resolution ** 3, LLFF_GRAPH_STEPS):
        fail(f"llff: the graphed training differs from the eager loop: "
             f"{differ}, launches {g_launches} / {e_launches}")

    # kernels 1 and 4 on NDC inputs of the 4-level grid, trained weights
    model, grid = g_state.model, g_state.grid
    padded, bR, cs, _ = march_inputs(gcfg, grid, val_split, dev)
    m, e = gcfg.model, gcfg.encoder
    params = kr.prep_params(
        model.state_dict(), n_layers=m.n_layers, skip=m.skip,
        n_freqs=e.n_freqs, n_freqs_views=e.n_freqs_views, device=dev)
    compare("llff ndc", kr.ray_march, kr.ray_march_reference, padded,
            params, bR, cs, s.early_stop_eps)
    dparams = km.prep_params(model.state_dict(), m.n_layers, m.skip)
    idx = torch.arange(grid.n_cells, device=dev)
    errs = []
    for lv in range(grid.levels):
        x = og._cell_positions(idx, og.level_aabb(grid.base_aabb, lv),
                               grid.resolution)[::7]
        encx = km.pad_features(positional_encoding(
            x, e.n_freqs, e.log_space), dparams.d_enc_pad)
        got_s = km.nerf_density(encx, dparams)
        ref_s = km.nerf_density_reference(encx, dparams)
        torch.cuda.synchronize()
        errs.append(float((got_s - ref_s).abs().max()
                          / (ref_s.abs().max() + 1e-9)))
    print(f"llff density kernel vs plain on each level's cell centres "
          f"(every 7th): sigma err "
          + ", ".join(f"{e:.3e}" for e in errs) + " of max |sigma|; aabb "
          f"{[round(float(v), 4) for v in grid.base_aabb]}")
    if max(errs) > DENSITY_SIGMA_TOL:
        fail(f"llff: density kernel vs plain {errs}")
    return launches, got["psnr"]


# -- 20. the data-parallel layer ------------------------------------------

PAR_STEPS = 20              # 20a: two gloo ranks on one card, eager
PAR_TOL = 1e-2              # of max |single-GPU weight|, and on the loss
NCCL_STEPS = 200            # 20b: one NCCL rank, graphed
LPIPS_RTOL = 1e-4           # 20c: the card against the CPU


def weights_digest(model) -> str:
    """sha256 of the model's parameters' bytes (bitwise comparison across
    processes)."""
    import hashlib

    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def par_setup(cfg, dev):
    """The slice of phase 20a: (config, scene, model, optimizer, state,
    pool) from seeded weights on the 8-view 128x128 sphere, PAR_STEPS
    steps."""
    import dataclasses

    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.train.step import init_state, make_optimizer

    tcfg = train_slice_config(cfg)
    tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train,
                                                  n_iters=PAR_STEPS))
    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    model = make_model(tcfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), dev)
    opt = make_optimizer(tcfg, model)
    state = init_state(model, tcfg, opt, scene.aabb, dev)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    return tcfg, scene, model, opt, state, pool


def par_refresh_jitter(grid, dev):
    """Seeded jitter of an all-cell and a part (1 of 4) refresh."""
    g = torch.Generator(device=dev).manual_seed(5)
    return {part: [torch.rand((grid.n_cells // (1 if part is None else 4),
                               3), generator=g, device=dev)]
            for part in (None, 1)}


def par_refresh(model, cfg, grid, jitter, mesh):
    """An all-cell refresh, then part 1, of `grid` through the density
    kernel (make_density_fn), sharded over mesh (None: replicated)."""
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.train.step import make_density_fn

    s = cfg.sampling
    out = {}
    with torch.no_grad():
        for part in (None, 1):
            og.update_(grid, make_density_fn(model, cfg, device=grid.occs
                                             .device), part, False,
                       render_step_size=s.render_step_size,
                       occ_thre=s.occ_thre, ema_decay=s.ema_decay,
                       jitter=jitter[part], shard=mesh)
            out[part] = (grid.occs.clone(), grid.thre.clone())
    return out


def par_view(model, cfg, grid, mesh, dev):
    """One 128x128 held-out view through the fused ray march (kernel 1),
    rendered tiled over mesh (None: one GPU)."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.render.renderer import render_frame

    s = cfg.sampling
    held = cli.split_of(SphereScene(n_imgs=8, hw=128,
                                    white_bkgd=True).holdout(n=1, seed=101))
    img, depth = render_frame(
        None, torch.as_tensor(held.poses[0], device=dev), held.hwf,
        held.near, held.far, grid=grid, n_samples=s.n_samples,
        render_step_size=s.render_step_size, white_bkgd=True,
        n_compact=cli.derive_eval_n_compact(grid, held, cfg, dev),
        early_stop_eps=s.early_stop_eps,
        query_stride=og.grid_query_stride(s, held.aabb, grid),
        fused_render_fn=cli.make_fused_render_fn(model.state_dict(), cfg,
                                                 device=dev), mesh=mesh)
    return img, depth


def gloo_rank(rank: int, workdir: str):
    """Phase 20a's rank (a spawned process): PAR_STEPS parallel steps on
    cuda:0 over gloo, the weights' digest after each, then the sharded
    refreshes and the tiled view, and the gloo all-reduce of the flattened
    gradient timed; writes <workdir>/rank<r>.pt."""
    import os

    import torch.distributed as dist

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.ops.kernels import build, launch_counts
    from fsnerf_tpu_torch.parallel import distributed_init, make_mesh
    from fsnerf_tpu_torch.parallel.train_parallel import \
        make_parallel_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.load_library()
    distributed_init("gloo", store=dist.FileStore(
        os.path.join(workdir, "store"), 2), rank=rank, world_size=2)
    mesh = make_mesh(2, device=dev)
    tcfg, scene, model, opt, state, pool = par_setup(Config(), dev)
    step = make_parallel_train_step(model, tcfg, opt, pool, scene, mesh)
    if step.graphed:
        fail("a gloo step must run eagerly")
    before = launch_counts()
    digests, losses = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_STEPS):
        state, m = step(state)
        losses.append(float(m["loss"]))
        digests.append(weights_digest(model))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    flat = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    mesh.all_mean_(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        mesh.all_mean_(flat)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) * 100.0
    grid = state.grid
    trained_grid = (grid.occs.cpu(), grid.thre.cpu())
    refreshed = par_refresh(model, tcfg, grid, par_refresh_jitter(grid, dev),
                            mesh)
    img, depth = par_view(model, tcfg, grid, mesh, dev)
    after = launch_counts()
    torch.save({"digests": digests, "losses": losses, "seconds": seconds,
                "allreduce_ms": allreduce_ms, "n_floats": flat.numel(),
                "weights": {n: p.detach().cpu() for n, p in
                            model.named_parameters()},
                "grid": trained_grid,
                "refreshed": {k: tuple(t.cpu() for t in v)
                              for k, v in refreshed.items()},
                "view": (img.cpu(), depth.cpu()),
                "launches": {k: after[k] - before[k] for k in after}},
               os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def gloo_two_ranks(cfg, dev, card):
    """Phase 20a: two ranks on cuda:0 over gloo (spawned, a FileStore in a
    temp dir), PAR_STEPS eager steps against as many single-GPU eager
    steps from the same seeds (the same draws): the loss at each step and
    the final weights within PAR_TOL of the single-GPU run's, the two
    ranks' weights bitwise equal after every step; then an all-cell and a
    part refresh sharded through kernel 4 and a 128x128 view tiled
    through kernel 1, each bitwise the single-GPU result."""
    import multiprocessing
    import os

    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.train.step import make_train_step

    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=gloo_rank, args=(r, work))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
        if codes != [0, 0]:
            fail(f"20a: the gloo ranks exited with {codes}")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    a, b = ranks
    if a["digests"] != b["digests"]:
        first = next(i for i, (x, y) in enumerate(zip(a["digests"],
                                                      b["digests"]))
                     if x != y)
        fail(f"20a: the ranks' weights differ from step {first + 1}")
    tcfg, scene, model, opt, state, pool = par_setup(cfg, dev)
    step = make_train_step(model, tcfg, opt, pool, scene)
    losses = []
    for _ in range(PAR_STEPS):
        state, m = step(state)
        losses.append(float(m["loss"]))
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], losses))
    w_err = max(float((a["weights"][n] - p.detach().cpu()).abs().max())
                / float(p.detach().abs().max())
                for n, p in model.named_parameters())
    # the refreshes and the view on one GPU, with rank 0's weights and grid
    model.load_state_dict({n: w.to(dev) for n, w in a["weights"].items()})
    og.set_occs_(state.grid, a["grid"][0].to(dev), a["grid"][1].to(dev))
    refreshed = par_refresh(model, tcfg, state.grid,
                            par_refresh_jitter(state.grid, dev), None)
    img, depth = par_view(model, tcfg, state.grid, None, dev)
    refresh_same = all(torch.equal(a["refreshed"][k][i],
                                   refreshed[k][i].cpu())
                       for k in (None, 1) for i in (0, 1))
    view_same = (torch.equal(a["view"][0], img.cpu())
                 and torch.equal(a["view"][1], depth.cpu()))
    need = ("mlp_train_fwd", "mlp_train_bwd", "nerf_density", "ray_march")
    print(f"20a. two gloo ranks on {card}: {PAR_STEPS} eager steps at "
          f"{PAR_STEPS / a['seconds']:.2f} steps/s per rank ("
          f"{2 * PAR_STEPS * (tcfg.train.batch_size // 2) / a['seconds']:.0f}"
          f" rays/s both), the gloo all-reduce of {a['n_floats']} gradient "
          f"floats {a['allreduce_ms']:.3f} ms per step; ranks' weights "
          f"bitwise equal after each of {len(a['digests'])} steps; vs "
          f"single-GPU: loss rel err {loss_err:.3e}, weights "
          f"{w_err:.3e} of max; sharded refresh (all cells, part 1) "
          + ("bitwise" if refresh_same else "DIFFERS")
          + "; tiled 128x128 view " + ("bitwise" if view_same else "DIFFERS")
          + f"; rank launches {dict((k, a['launches'][k]) for k in need)}; "
          f"{wall:.1f} s with the spawn")
    if loss_err > PAR_TOL or w_err > PAR_TOL:
        fail(f"20a: the parallel steps left the single-GPU ones: loss "
             f"{loss_err}, weights {w_err}")
    if not refresh_same or not view_same:
        fail("20a: the sharded refresh or the tiled view is not the "
             "single-GPU one")
    for r in ranks:
        if min(r["launches"][k] for k in need) == 0:
            fail(f"20a: a rank did not launch {need}: {r['launches']}")


def nccl_one_rank(cfg, dev, card):
    """Phase 20b: train(..., mesh=) over a one-rank NCCL group, graphed,
    NCCL_STEPS steps against the single-GPU graphed loop from the same
    seeds: weights, Adam moments, grid, generator and launch counts
    bitwise equal."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from fsnerf_tpu_torch.parallel import make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device=dev)
        tcfg = train_slice_config(cfg)
        tcfg = tcfg.replace(train=dataclasses.replace(tcfg.train,
                                                      n_iters=NCCL_STEPS))
        runs = {}
        for name, m in (("single", None), ("nccl", mesh)):
            _, state, _, launches, seconds, rungs, _ = run_train_slice(
                tcfg, dev, mesh=m)
            runs[name] = (state, launches, seconds, rungs)
    finally:
        dist.destroy_process_group()
    (s1, l1, t1, r1), (s2, l2, t2, r2) = runs["single"], runs["nccl"]
    graphed = bool(r2.rungs)        # a rung is logged once it has graphs
    differ = state_diffs(s1, s2)
    if l1 != l2:
        differ.append("launches")
    print(f"20b. one NCCL rank on {card}: train(mesh=) "
          + ("graphed" if graphed else "eager")
          + f", {NCCL_STEPS} steps at {NCCL_STEPS / t2:.2f} steps/s "
          f"({r2.summary()}) against the single-GPU graphed loop at "
          f"{NCCL_STEPS / t1:.2f} steps/s ({r1.summary()}); weights, Adam "
          f"moments, grid, generator and launches "
          + ("bitwise equal" if not differ else f"differ: {differ}")
          + f"; launches {dict((k, v) for k, v in l2.items() if v)}")
    if differ or not graphed:
        fail(f"20b: the one-rank NCCL run is not the single-GPU graphed "
             f"loop: {differ}, graphed {graphed}")


def lpips_card(card):
    """Phase 20c: LPIPS with seeded random VGG16 and head weights (an npz
    written here) on two 128x128 frames on the card against the same on
    the CPU, within LPIPS_RTOL; TF32 off."""
    import os

    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.eval.lpips import _VGG_CFG, load_lpips

    rng = np.random.default_rng(0)
    w, cin, i = {}, 3, 0
    for c in _VGG_CFG:
        if c == "M":
            continue
        w[f"conv{i}_kernel"] = (rng.standard_normal((3, 3, cin, c))
                                * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        w[f"conv{i}_bias"] = (0.01 * rng.standard_normal(c)).astype(
            np.float32)
        cin, i = c, i + 1
    for j, c in enumerate((64, 128, 256, 512, 512)):
        w[f"lin{j}"] = rng.uniform(0.0, 1.0, c).astype(np.float32)
    scene = SphereScene(n_imgs=2, hw=128, white_bkgd=True)
    a = torch.as_tensor(scene.imgs[0], dtype=torch.float32)
    b = torch.as_tensor(scene.imgs[1], dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lpips.npz")
        np.savez(path, **w)
        on_card = load_lpips(path, device="cuda")
        on_cpu = load_lpips(path, device="cpu")
    got = float(on_card(a.cuda(), b.cuda()))
    want = float(on_cpu(a, b))
    ms = cuda_ms(lambda: on_card(a.cuda(), b.cuda()), 5)
    err = abs(got - want) / abs(want)
    print(f"20c. LPIPS (seeded weights) of two 128x128 frames on {card}: "
          f"{got:.6f} vs {want:.6f} on the CPU, rel err {err:.3e}; "
          f"{ms:.3f} ms per pair")
    if not err <= LPIPS_RTOL:
        fail(f"20c: LPIPS on the card {got} vs the CPU {want}")


# -- 21. the serving artifact ----------------------------------------------

EXPORT_CHUNK = 2048         # the CLI's export chunk: min(16384, 2 x batch)
EXPORT_FRAMES = 4           # 128x128 path frames timed through each route
# the artifact's frame (kernel 3, plain compositing) against the CLI's
# render of the same view (kernel 1): phase 9's HIER_FUSED_PSNR_TOL_DB
# between these two routes; kernel 1's max-abs tolerances against its
# plain version (RGB_OPACITY_TOL, DEPTH_TOL) need not hold between them on
# every pixel of a view: kernel 1 encodes with the polynomial sine, kernel
# 3's caller with torch's, and each rounds the features to bf16

# the fresh process: torch and the port's op library only; it replays the
# first chunk of each artifact and reports its launches and the port's
# modules it imported
REPLAY_PROCESS = r"""
import sys
import torch
from fsnerf_tpu_torch.ops.kernels import register_ops
register_ops()
from fsnerf_tpu_torch.ops.kernels import mlp, siren
out = {}
for art, rays in zip(sys.argv[1::2], sys.argv[2::2]):
    before = (mlp.nerf_mlp.launches, siren.siren_mlp_fwd.launches)
    program = torch.export.load(art + "/renderer.pt2").module()
    r = torch.load(rays)
    with torch.no_grad():
        rgb, depth = program(r["o"].cuda(), r["d"].cuda())
    torch.cuda.synchronize()
    out[art] = {"rgb": rgb.cpu(), "depth": depth.cpu(), "launches": (
        mlp.nerf_mlp.launches - before[0],
        siren.siren_mlp_fwd.launches - before[1])}
out["modules"] = sorted(m for m in sys.modules
                        if m.startswith("fsnerf_tpu_torch"))
torch.save(out, sys.argv[1] + "/replay.pt")
"""


def artifact_mb(art: str) -> float:
    import os

    return sum(os.path.getsize(os.path.join(art, f))
               for f in ("renderer.pt2", "meta.json")) / 2 ** 20


def export_slice(label, model, cfg, grid, wrapper, dev, card, workdir):
    """Phase 21a / 21b: the serving renderer of `model` (cli.serving_renderer
    on 4 path poses of the 128x128 sphere: the eval model_fn through the
    kernel's op, the plain compositing, chunks of 2,048 rays) exported on
    the card, saved and loaded; a frame replayed through
    render_frame_exported must equal render_frame through the live renderer
    bitwise, `wrapper`'s launches growing by the frame's chunk count;
    compact_transfer gives to8b of the f32 frame. Returns (the artifact's
    directory, the chunk-0 rays and the live outputs for the fresh
    process, the launches of the replays)."""
    import os

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.data.rays import get_rays
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.render.renderer import render_frame, to8b
    from fsnerf_tpu_torch.utils import export

    scene = SphereScene(n_imgs=1, hw=128)
    poses = scene.path_poses[:EXPORT_FRAMES]
    split = cli.Split(np.zeros((len(poses), 128, 128, 3), np.float32),
                      poses, scene.hwf, scene.near, scene.far, False,
                      scene.aabb, True)
    live, chunk = cli.serving_renderer(model, cfg, grid, split, dev)
    if chunk != EXPORT_CHUNK:
        fail(f"21{label}: the serving chunk is {chunk}, not {EXPORT_CHUNK}")
    art = os.path.join(workdir, cfg.model.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export.export_render_artifact(
        live, chunk, art, hwf=scene.hwf, near=scene.near, far=scene.far,
        extra_meta={"model": cfg.model.model,
                    "strategy": cfg.sampling.strategy, "step": 0})
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn, meta = export.load_render_artifact(art)
    load_s = time.perf_counter() - t0
    if meta["platforms"] != ["cuda"]:
        fail(f"21{label}: meta.json names {meta['platforms']}")
    on_dev = [torch.as_tensor(np.asarray(p, np.float32), device=dev)
              for p in poses]

    def live_frames():
        out = [render_frame(None, p, scene.hwf, scene.near, scene.far,
                            chunksize=chunk, chunk_renderer=live)
               for p in on_dev]
        return [(a.cpu().numpy(), b.cpu().numpy()) for a, b in out]

    def replay_frames():
        return [export.render_frame_exported((fn, meta), p) for p in poses]

    want = live_frames()
    t0 = time.perf_counter()
    live_frames()
    live_fps = len(poses) / (time.perf_counter() - t0)
    n_chunks = -(-scene.hwf[0] * scene.hwf[1] // chunk)
    wrapper.launches = 0
    first = export.render_frame_exported((fn, meta), poses[0])
    if wrapper.launches != n_chunks:
        fail(f"21{label}: the replayed frame launched {wrapper.__name__} "
             f"{wrapper.launches} times, not once per chunk ({n_chunks})")
    got = replay_frames()
    t0 = time.perf_counter()
    replay_frames()
    fps = len(poses) / (time.perf_counter() - t0)
    rgb8, depth16 = export.render_frame_exported((fn, meta), poses[0],
                                                 compact_transfer=True)
    launches = wrapper.launches
    for i, ((a, b), (c, d)) in enumerate(zip([first] + got,
                                            [want[0]] + want)):
        if not (np.array_equal(a, c) and np.array_equal(b, d)):
            fail(f"21{label}: replayed frame {i} differs from the live "
                 f"renderer's: rgb {np.abs(a - c).max()}, depth "
                 f"{np.abs(b - d).max()}")
    if not np.array_equal(rgb8, to8b(first[0])) or not np.allclose(
            depth16.astype(np.float32), first[1], rtol=2e-3):
        fail(f"21{label}: compact_transfer is not to8b of the f32 frame")
    if not np.isfinite(first[0]).all() or first[0].shape != (128, 128, 3):
        fail(f"21{label}: bad frame {first[0].shape}")
    print(f"21{label}. {cfg.model.model} artifact ({cfg.model.n_layers}x"
          f"{cfg.model.d_filter}, res-{grid.resolution} grid, chunk "
          f"{chunk}, {meta['device_name']}) on {card}: export "
          f"{export_s:.3f} s, load {load_s:.3f} s, {artifact_mb(art):.3f} "
          f"MB; replay == live bitwise over {1 + 2 * len(poses)} frames "
          f"128x128, {wrapper.__name__} launches {launches} ({n_chunks} "
          f"per frame); render_frame_exported {fps:.3f} frames/s vs live "
          f"render_frame {live_fps:.3f} frames/s; compact_transfer == to8b")
    ro, rd = get_rays(on_dev[0], scene.hwf)
    rays = {"o": ro.reshape(-1, 3)[:chunk].cpu(),
            "d": rd.reshape(-1, 3)[:chunk].cpu()}
    with torch.no_grad():
        ref = fn(rays["o"].to(dev), rays["d"].to(dev))
    return art, rays, [r.cpu() for r in ref], launches


def fresh_replay(jobs, card):
    """Phase 21, the fresh process: REPLAY_PROCESS loads each artifact and
    replays its first chunk; each must equal this process's replay
    bitwise with one launch of its kernel, and the process must have
    imported no model, config, checkpoint or renderer code of the port."""
    import os

    arts = []
    for art, rays, _, _ in jobs:
        torch.save(rays, os.path.join(art, "rays.pt"))
        arts += [art, os.path.join(art, "rays.pt")]
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", REPLAY_PROCESS, *arts],
                   check=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    seconds = time.perf_counter() - t0
    out = torch.load(os.path.join(jobs[0][0], "replay.pt"))
    banned = [m for m in out["modules"] if any(m.startswith(
        f"fsnerf_tpu_torch.{p}") for p in ("core.models", "config", "cli",
                                           "utils", "render", "train"))]
    if banned:
        fail(f"21: the replaying process imported {banned}")
    for (art, _, ref, _), want in zip(jobs, ((1, 0), (0, 1))):
        got = out[art]
        if not (torch.equal(got["rgb"], ref[0])
                and torch.equal(got["depth"], ref[1])):
            fail(f"21: the fresh process's replay of {art} differs")
        if tuple(got["launches"]) != want:
            fail(f"21: the fresh process launched (nerf_mlp, siren_mlp_fwd)"
                 f" {got['launches']} for {art}, not {want}")
    print(f"21. a fresh process (torch and fsnerf_tpu_torch.ops.kernels "
          f"only: {len(out['modules'])} modules of the port, no model, "
          f"config, checkpoint or renderer) loaded both artifacts and "
          f"replayed a chunk of each bitwise, one launch each, in "
          f"{seconds:.3f} s with its start on {card}")


def blender_artifact(dev, card, flags, out_dir, art, exported_s):
    """Phase 21c: the Blender slice's --export_render artifact (phase 17's
    training run wrote it) renders the first test view. It must equal,
    bitwise, the same view through cli.serving_renderer rebuilt from the
    run's checkpoint (what the CLI exported: the checkpoint's weights and
    grid, the path's K and query stride, kernel 3); and it is held against
    the CLI's own render of that view (evaluate_split's route: the fused
    ray march, kernel 1) at the same K by PSNR, within the 0.5 dB phase 9
    allows between the kernel-1 and kernel-3 routes, with the largest
    differences and the pixels beyond kernel 1's tolerances (rgb 7e-3,
    depth 3e-2) printed. Returns the artifact's launches of kernel 3."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.eval.metrics import psnr
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.render.renderer import (make_chunk_renderer,
                                                  render_frame)
    from fsnerf_tpu_torch.utils import export

    bcfg = cli.config_from_args(flags + ["--out_dir", out_dir])
    train_split, _, test_split = cli.make_splitter(bcfg).get_splits()
    dtype = (torch.bfloat16 if bcfg.train.dtype == "bfloat16"
             else torch.float32)
    model = make_model(bcfg, dtype,
                       torch.Generator().manual_seed(bcfg.train.seed), dev)
    grid, step = cli.restored_grid(model, bcfg, train_split,
                                   cli.run_dir(bcfg), dev)
    t0 = time.perf_counter()
    fn, meta = export.load_render_artifact(art)
    load_s = time.perf_counter() - t0
    if (meta["step"], meta["model"], meta["chunksize"]) != (
            step, "nerf", EXPORT_CHUNK):
        fail(f"21c: the artifact's meta.json holds {meta}")
    pose = test_split.poses[0]
    pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=dev)
    km.nerf_mlp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, depth = export.render_frame_exported((fn, meta), pose)
    replay_s = time.perf_counter() - t0
    launches = km.nerf_mlp.launches
    H, W, _ = test_split.hwf
    if launches != -(-H * W // EXPORT_CHUNK):
        fail(f"21c: the test view launched kernel 3 {launches} times")
    live, chunk = cli.serving_renderer(model, bcfg, grid, train_split, dev)
    want = render_frame(None, pose_t, test_split.hwf, test_split.near,
                        test_split.far, chunksize=chunk,
                        chunk_renderer=live)
    if not (np.array_equal(rgb, want[0].cpu().numpy())
            and np.array_equal(depth, want[1].cpu().numpy())):
        fail("21c: the CLI's artifact differs from its serving renderer "
             "rebuilt from the checkpoint")
    s = bcfg.sampling
    cli_renderer = make_chunk_renderer(
        cli.make_render_model_fn(model, bcfg, device=dev),
        strategy=s.strategy, grid=grid, n_samples=s.n_samples,
        render_step_size=s.render_step_size,
        white_bkgd=test_split.white_bkgd, near=test_split.near,
        far=test_split.far,
        n_compact=cli.derive_eval_n_compact(grid, train_split, bcfg, dev),
        early_stop_eps=s.early_stop_eps,
        query_stride=og.grid_query_stride(s, test_split.aabb, grid),
        fused_render_fn=cli.make_fused_render_fn(model.state_dict(), bcfg,
                                                 device=dev),
        composite_fn=cli.make_composite_fn(bcfg, dev))
    kr.ray_march.launches = 0
    ref_rgb, ref_depth = render_frame(
        None, pose_t, test_split.hwf, test_split.near, test_split.far,
        chunksize=cli.EVAL_CHUNK, chunk_renderer=cli_renderer)
    if kr.ray_march.launches == 0:
        fail("21c: the CLI's render of the test view did not launch "
             "kernel 1")
    rgb_diff = np.abs(rgb - ref_rgb.cpu().numpy()).max(axis=-1)
    depth_diff = np.abs(depth - ref_depth.cpu().numpy())
    gt = torch.as_tensor(test_split.imgs[0])
    p_art = float(psnr(torch.as_tensor(rgb), gt))
    p_cli = float(psnr(ref_rgb.cpu(), gt))
    print(f"21c. blender --export_render artifact ({meta['hwf'][0]}x"
          f"{meta['hwf'][1]}, step {step}) on {card}: exported by the CLI "
          f"in {exported_s:.3f} s, {artifact_mb(art):.3f} MB, loaded in "
          f"{load_s:.3f} s; test view 0 replayed in {replay_s:.3f} s "
          f"({launches} kernel-3 launches), bitwise the serving renderer "
          f"rebuilt from the checkpoint; PSNR {p_art:.4f} vs the CLI's own "
          f"render (kernel 1) {p_cli:.4f}; max abs diff rgb "
          f"{rgb_diff.max():.3e} (99.99th percentile "
          f"{np.quantile(rgb_diff, 0.9999):.3e}; "
          f"{int((rgb_diff > RGB_OPACITY_TOL).sum())} of {rgb_diff.size} "
          f"pixels beyond {RGB_OPACITY_TOL}), depth {depth_diff.max():.3e} "
          f"({int((depth_diff > DEPTH_TOL).sum())} beyond {DEPTH_TOL})")
    if abs(p_art - p_cli) > HIER_FUSED_PSNR_TOL_DB:
        fail(f"21c: the artifact's test view PSNR {p_art} is off the CLI's "
             f"{p_cli}")
    return launches


def serving_artifact(model, grid, cfg, dev, card, blender):
    """Phase 21: the serving artifact (utils/export.py) of NeRF and SiNeRF
    at full width, a fresh process replaying both, and the Blender slice's
    --export_render artifact. Returns the launches of kernels 3 and 7 in
    the replays."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    t0 = time.perf_counter()
    scfg = sinerf_config(cfg)
    smodel = make_model(scfg, torch.bfloat16,
                        torch.Generator().manual_seed(0), dev)
    sgrid = cli.rebuild_grid(smodel, scfg, SphereScene(n_imgs=1,
                                                       hw=128).aabb, dev)
    with tempfile.TemporaryDirectory() as workdir:
        nerf = export_slice("a", model, cfg, grid, km.nerf_mlp, dev, card,
                            workdir)
        siren = export_slice("b", smodel, scfg, sgrid, ks.siren_mlp_fwd,
                             dev, card, workdir)
        fresh_replay([nerf, siren], card)
    blender_launches = blender_artifact(dev, card, *blender)
    print(f"21. serving artifact phase: {time.perf_counter() - t0:.1f} s")
    return {"nerf_mlp": nerf[3] + blender_launches,
            "siren_mlp_fwd": siren[3]}


# -- 22. JPEG: the decoder on the card's machine -------------------------

JPEG_BIG_VIEWS, JPEG_BIG_W, JPEG_BIG_H = 20, 4032, 3024  # a full-size LLFF set


def jpeg_fixtures():
    """22a: tests/data/jpeg/'s JPEGs (tests/make_jpeg_fixtures.py) through
    the port's decoder, each bitwise the pixels libjpeg-turbo gives
    (pixels.npz) times 1/255."""
    import os

    from fsnerf_tpu_torch.native import decode_images

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "jpeg")
    with np.load(os.path.join(root, "pixels.npz")) as npz:
        want = {n: npz[n] for n in npz.files}
    inv255 = np.float32(1) / np.float32(255)
    bad = [n for n, px in want.items()
           if not np.array_equal(decode_images([os.path.join(root, n)])[0],
                                 np.multiply(px, inv255, dtype=np.float32))]
    print(f"22a. JPEG fixtures: {len(want) - len(bad)} of {len(want)} "
          f"decoded bitwise to libjpeg-turbo's pixels ({sorted(want)})")
    if bad or len(want) < 5:
        fail(f"22a: the decoder's pixels differ from libjpeg-turbo's on "
             f"{bad}")


def pil_differences(paths, imgs) -> dict:
    """The port's decode `imgs` (float32) of JPEG `paths` against PIL's
    decode of the same files: values that differ, and the largest
    difference in 8-bit steps."""
    from PIL import Image

    n_diff, worst = 0, 0
    for path, img in zip(paths, imgs):
        with Image.open(path) as im:
            ref = np.asarray(im.convert("RGB"), np.int16)
        d = np.abs(np.round(img * 255).astype(np.int16) - ref)
        n_diff += int((d > 0).sum())
        worst = max(worst, int(d.max()))
    return {"values_differing": n_diff, "max_step": worst}


def jpeg_llff_slice(card, root, png_psnr):
    """22b: the CLI's LLFF flow (--debug: splits, training, val and test)
    on phase 18's lattice scene with its images_8/ written as JPEG, the
    launches of kernels 5, 6, 4 and 1 read around the training run and
    checked as phase 18 checks them; the views decoded against PIL's
    decode of the same files."""
    import os

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.native import decode_images
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    t0 = time.perf_counter()
    scene = write_llff_scene(root, "lattice_jpeg", jpeg=True)
    img_dir = os.path.join(root, "llff", scene, "images_8")
    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    imgs = decode_images(files)
    decode_s = time.perf_counter() - t0
    vs_pil = pil_differences(files, imgs)
    flags = ["--dataset", "llff", "--scene", scene, "--data_root", root,
             "--n_imgs", "8", "--n_iters", str(LLFF_STEPS), "--debug"]
    base = run_cli(flags + ["--render_only"])
    kr.ray_march.launches = km.nerf_density.launches = 0
    mt.mlp_train_fwd.launches = mt.mlp_train_bwd.launches = 0
    got = run_cli(flags)
    torch.cuda.synchronize()
    launches = {"mlp_train_fwd": mt.mlp_train_fwd.launches,
                "mlp_train_bwd": mt.mlp_train_bwd.launches,
                "nerf_density": km.nerf_density.launches,
                "ray_march": kr.ray_march.launches}
    steps = got["steps"]
    lcfg = cli.config_from_args(flags)
    n_held = int(0.15 * LLFF_VIEWS)
    print(f"22b. llff scene as JPEG (quality 95, 4:2:0) on {card}: "
          f"{LLFF_VIEWS} views {LLFF_W}x{LLFF_H} synthesized and written in "
          f"{synth_s:.3f} s, decoded in {decode_s:.3f} s; against PIL's "
          f"decode {vs_pil}; views {got['views']}; {steps} steps at "
          f"{steps / got['train_seconds']:.2f} steps/s; val PSNR "
          f"{got['psnr']:.3f} (untrained {base['psnr']:.3f}; phase 18's "
          f"PNG scene {png_psnr:.3f}), test PSNR {got['test_psnr']:.3f}; "
          f"launches {launches}")
    if got["views"] != {"train": 8, "val": n_held, "test": n_held}:
        fail(f"22b: splits {got['views']}")
    if got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
        fail(f"22b: val PSNR {got['psnr']:.3f} is not {MIN_PSNR_GAIN_DB} "
             f"dB above the untrained {base['psnr']:.3f}")
    want = refresh_launches(lcfg, lcfg.sampling.grid_resolution ** 3, steps)
    if min(launches.values()) == 0 or launches["mlp_train_fwd"] != steps \
            or launches["mlp_train_bwd"] != steps \
            or launches["nerf_density"] != want:
        fail(f"22b: the run launched {launches} in {steps} steps "
             f"({want} density launches expected)")


def jpeg_decode_rate(card, root):
    """22c: JPEG_BIG_VIEWS views at JPEG_BIG_W x JPEG_BIG_H (4:2:0, quality
    95, written by PIL) decoded by the port to float32, as images/s and
    megapixels/s, beside PIL's decode of the same files to uint8 (a
    yardstick, not a target) and the values where the two differ."""
    import os

    from PIL import Image

    from fsnerf_tpu_torch.native import decode_images

    h, w = JPEG_BIG_H, JPEG_BIG_W
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(xx / 83.0) * np.cos(yy / 61.0),
                     128 + 90 * np.cos((xx + yy) / 47.0),
                     (xx / 16 + yy / 12) % 256], -1)
    base = (base + rng.normal(0, 8, base.shape)).clip(0, 255).astype(
        np.uint8)
    del yy, xx
    big = os.path.join(root, "jpeg_big")
    os.makedirs(big)
    files = []
    t0 = time.perf_counter()
    for i in range(JPEG_BIG_VIEWS):
        files.append(os.path.join(big, f"im_{i:03d}.jpg"))
        Image.fromarray(np.roll(base, 97 * i, axis=1)).save(
            files[-1], quality=95, subsampling=2)
    write_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(f) for f in files) / 1e6
    t0 = time.perf_counter()
    imgs = decode_images(files)
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for f in files:
        with Image.open(f) as im:
            np.asarray(im.convert("RGB"))
    pil_s = time.perf_counter() - t0
    vs_pil = pil_differences(files, imgs)
    mpix = JPEG_BIG_VIEWS * h * w / 1e6
    print(f"22c. JPEG decode of {JPEG_BIG_VIEWS} views {w}x{h} (4:2:0, "
          f"quality 95, {mb:.1f} MB, written by PIL in {write_s:.3f} s) on "
          f"the host of {card} ({os.cpu_count()} cores): the port "
          f"{port_s:.3f} s to float32, {JPEG_BIG_VIEWS / port_s:.3f} "
          f"images/s, {mpix / port_s:.1f} megapixels/s; PIL {pil_s:.3f} s "
          f"to uint8, {JPEG_BIG_VIEWS / pil_s:.3f} images/s, "
          f"{mpix / pil_s:.1f} megapixels/s; against PIL's pixels {vs_pil}")
    if imgs.shape != (JPEG_BIG_VIEWS, h, w, 3):
        fail(f"22c: decoded {imgs.shape}")


def jpeg_phase(card, root, png_psnr):
    """Phase 22: the decoder's JPEG path on the card's machine (which has
    no libjpeg): the fixtures, the LLFF flow over JPEG views and the
    decode rate of a full-size LLFF set."""
    import PIL
    import PIL.features

    t0 = time.perf_counter()
    jpeg_fixtures()
    print(f"22. PIL {PIL.__version__}: JPEG codec "
          f"{PIL.features.check('jpg')} (libjpeg "
          f"{PIL.features.version('jpg')}, libjpeg-turbo "
          f"{PIL.features.check_feature('libjpeg_turbo')})")
    if not PIL.features.check("jpg"):
        fail("22: PIL has no JPEG codec here to write the JPEG scenes")
    jpeg_llff_slice(card, root, png_psnr)
    jpeg_decode_rate(card, root)
    print(f"22. JPEG phase: {time.perf_counter() - t0:.1f} s")


# -- 19. the kernels at every width up to W_max -----------------------------
#
# A NeRF or SiNeRF module's width is packed at the next of the kernels'
# widths 64, 128, 192, 256, 384, 512 or, above 512, the next multiple of
# 256 from 768 up (ops/kernels/render.py::kernel_width; 384 and 512 on the
# column-split trunk, 768 and up on the streamed trunk, one instance for
# every streamed width; a NeRF of 193-256 units whose direction encoding
# is wider than 128 at 384) with zero units, up to W_max, the widest whose
# packed weights int32 offsets address (render.py::MAX_PACKED_WEIGHTS:
# 15,872 for this NeRF, 15,360 for the 8-layer SiNeRF). NeRF: kernels 1
# and 3-6 at widths 40, 96, 192, 200, 300, 512, 700, 1024, 1100 (packed
# 1280), 2048 and W_max (8 layers, skip 4, n_freqs 10/4), at 256 and 512
# with n_freqs 21 (a 129-wide encoding) and at 256 with n_freqs_views 21
# (packed 384); SiNeRF: kernels 2, 7, 8 at 40, 100, 192, 300, 512, 700,
# 1024, 1100, 2048 and W_max (8 layers), the mma.sync forward and march at
# 320 packed at 320; past W_max the printed module route.
WIDTH_NERF = ((40, {}), (96, {}), (192, {}), (200, {}),
              (256, {"n_freqs": 21}), (256, {"n_freqs_views": 21}),
              (300, {}), (512, {}), (512, {"n_freqs": 21}), (700, {}),
              (1024, {}), (1100, {}), (2048, {}))
WIDTH_SIREN = (40, 100, 192, 300, 512, 700, 1024, 1100, 2048)
# At W_max the main path's rows do not fit the card (kernel 6's saved
# activations and cotangents at 196,608 rows of 8 x 15,872 take ~100 GB):
# kernels 3-8 there run WMAX_ROWS rows (their rows times a row's elements
# still pass 2^31 in the acts stream and the cotangents, so a 32-bit row
# offset would show), the marches one ray block per SM of the card (phase
# 3's first rays: each persistent CTA takes one block), the plain marches
# the first block of that launch,
# the plain versions WMAX_PLAIN_ROWS rows (seconds a call).
WMAX_ROWS = 16_384
WMAX_PLAIN_ROWS = 2_048
# Above width 256 a plain call takes 0.02-13 s: each kernel is timed over
# WIDE_KERNEL_REPS calls (at W_max one), its plain version in one, the
# bf16 module over MODULE_REPS_WIDE (in_turns(quick=...)), at W_max in one
# call without an untimed one (the SiNeRF module's march there takes ~30 s).
WIDE_KERNEL_REPS = 3
MODULE_REPS_WIDE = 1
# the report's wide instances (phase 19's numbers, their launches from
# phase 2b's runs at those widths)
NERF_REPORT_WIDTHS = (512, 768, 1024, 2048)
SIREN_REPORT_WIDTHS = (512, 1024)
# 19c: training runs at 8 x W, each for this many graphed steps (8 x 1024
# through the module trains at ~22 steps/s: TRAIN_STEPS of it would take
# ~70 s of the script's time; every width cut to 600 steps to make room,
# then to 300, then to 200 for the 8 x 2048 slice (at 150: 5.3-5.8 steps/s
# on either route): at 150 the 8 x 192 slice's held-out PSNR rose 4.8 dB,
# under MIN_PSNR_GAIN_DB)
WIDTH_TRAIN = {192: 200, 200: 200, 512: 200, 1024: 200, 2048: 150}
WIDTH_ROUTES = (192, 200, 512, 700, 1024, 2048)   # 2b: the routes traced
# 19c: SiNeRF training at 8 x W for this many graphed steps: the module
# route trains at ~10 steps/s at 8 x 512, ~3.3 at 8 x 1024 and ~1.4 at 8 x
# 1536, so TRAIN_STEPS of any would take 150-1,000 s of the script's time
# (512 cut from 600 to 200 steps to make room for 1024, then to 150 for
# 1536, whose slice takes the place of 1024's: the streamed SIREN kernels
# at 1024 still train in phase 2b and run in 19b; 2048's module route,
# ~0.8 steps/s, does not fit)
WIDTH_SIREN_TRAIN = {512: 150, 1536: 120}
WIDTH_ROUTE_STEPS = 20                # 2b: steps traced for the route
# 19c from 384 up: the held-out PSNR of the kernels' run against the
# module's (the same function, bf16 rounded in other places); above 1024
# within WIDEST_PSNR_TOL_DB
WIDE_PSNR_TOL_DB = 1.0
WIDEST_PSNR_TOL_DB = 0.5
# Above 1024 a gradient off by more than GRAD_TOL of its max from the plain
# version's is decided by scripts/grad_arbiter.py's float64 arbiter (the
# tensor cores' f32 sums over K = W flip bf16 roundings of the backward's
# intermediates ~linearly in K): the kernel's worst error against it must
# stay within ARBITER_FACTOR of the plain version's (from the kernel's
# saved activations), the factor ROADMAP Queue 3 states.
ARBITER_FACTOR = 3.0


def nerf_route_kernels(width: int):
    """(names launched with the packed width as template argument, names
    without one) of the NeRF training and eval kernels at a packed width:
    at the streamed widths one instance each (<name>_stream) serves them
    all."""
    from fsnerf_tpu_torch.ops.kernels import render as kr

    names = ("mlp_train_fwd_kernel", "nerf_density_kernel",
             "nerf_march_kernel")
    if kr.stream_width(width):
        return (), tuple(f"{n}_stream" for n in names) + (
            "mlp_train_bwd_rows_kernel_stream",) + NERF_BWD_PARTS[1:]
    return names, NERF_BWD_PARTS


def width_cfg(cfg, width, **encoder):
    """cfg at another width (and encoder fields)."""
    import dataclasses

    return cfg.replace(
        model=dataclasses.replace(cfg.model, d_filter=width),
        encoder=dataclasses.replace(cfg.encoder, **encoder))


class ModuleCalls:
    """Counts the forward calls of every NeRF / SiNeRF module while open:
    0 means no module GEMM ran on the MLP. `density_calls` counts those
    given no view directions (the grid refresh's densities), `calls` the
    others."""

    def __enter__(self):
        from fsnerf_tpu_torch.core.models import NeRF, SiNeRF

        self.calls = self.density_calls = 0

        def hook(module, args):
            if isinstance(module, (NeRF, SiNeRF)):
                if len(args) > 1 and args[1] is not None:
                    self.calls += 1
                else:
                    self.density_calls += 1

        self.handle = \
            torch.nn.modules.module.register_module_forward_pre_hook(hook)
        return self

    @property
    def total(self) -> int:
        return self.calls + self.density_calls

    def __exit__(self, *exc):
        self.handle.remove()


def width_routes(cfg, dev, card):
    """Phase 2b, after the build (as siren_routes, for the profiler): at 8 x
    W for W in WIDTH_ROUTES (200 padded to 256, 700 to 768),
    WIDTH_ROUTE_STEPS train steps of the occgrid slice and the held-out
    eval of one view must launch kernels 5, 6, 4 and 1 at the packed width
    (mlp_train_fwd_kernel<W>, the row pass and dW pass of mlp_train_bwd,
    nerf_density_kernel<W>, nerf_march_kernel<W>; at 768 and 1024 the
    streamed instances, nerf_route_kernels) and call no NeRF module; from
    512 up also a hierarchical held-out eval of the view (kernel 3 on the
    coarse samples, kernel 1 on the fine), its launches counted with the
    run's. At SiNeRF 8 x 512 kernels 7, 8 and 2 (siren_fwd_ws_kernel<512>,
    siren_bwd_rows_ws_kernel<512> and the dW pass, siren_march_kernel<512>)
    and at 8 x 1024 their streamed instances (siren_fwd_kernel_stream,
    siren_bwd_rows_kernel_stream, siren_march_kernel_stream), the SiNeRF
    module called only for the grid refresh's densities. Returns ({packed
    width: the launch counts of its NeRF run} from 512 up, {SiNeRF width:
    the launch counts of its run})."""
    import dataclasses

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import launch_counts
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.train import step
    from fsnerf_tpu_torch.train.loop import train

    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    held = cli.split_of(scene.holdout(n=1, seed=101))
    wide = {}
    for W in WIDTH_ROUTES:
        K = kr.nerf_kernel_width(W)
        wcfg = train_slice_config(width_cfg(cfg, W))
        wcfg = wcfg.replace(train=dataclasses.replace(
            wcfg.train, n_iters=WIDTH_ROUTE_STEPS))
        if not step.resolve_fused_kernel(wcfg, dev):
            fail(f"width {W}: the kernels' route did not resolve on the card")
        model = make_model(wcfg, torch.bfloat16,
                           torch.Generator().manual_seed(5), dev)
        state = None

        def run():
            nonlocal state
            state = train(model, wcfg, pool, scene, logger=ListLogger(),
                          log_every=WIDTH_ROUTE_STEPS)
            cli.evaluate_split(model, og.conservative(state.grid), held,
                               wcfg, device=dev)
            if K >= 512:
                cli.evaluate_split(model, None, held, hier_config(wcfg),
                                   device=dev)

        names, plain = nerf_route_kernels(K)
        if K >= 512:                  # the hierarchical eval's kernel 3
            if kr.stream_width(K):
                plain += ("nerf_mlp_kernel_stream",)
            else:
                names += ("nerf_mlp_kernel",)
        before = launch_counts()
        with ModuleCalls() as calls:
            seen = require_kernels(
                f"2b. {WIDTH_ROUTE_STEPS} train steps and a held-out view at "
                f"8 x {W} (packed {K})", run, names, K, plain=plain)
        after = launch_counts()
        if K >= 512:
            wide[K] = {k: after[k] - before[k] for k in after}
        gemms = sorted(k for k in seen if re.search(
            r"gemm|xmma|nvjet|cutlass", k) and "dw_gemm_kernel" not in k)
        print(f"2b. width {W}: NeRF module calls {calls.total}; other GEMM "
              f"kernels seen {len(gemms)} {[k[:60] for k in gemms]}")
        if calls.total:
            fail(f"width {W}: the run called the NeRF module "
                 f"{calls.total} times")
    # SiNeRF 8 x 512 on the column-split SIREN kernels, 8 x 1024 on the
    # streamed ones
    siren_wide = {}
    for W in SIREN_REPORT_WIDTHS:
        scfg = sinerf_config(train_slice_config(width_cfg(cfg, W)),
                             n_iters=WIDTH_ROUTE_STEPS)
        if not step.resolve_fused_kernel(scfg, dev):
            fail(f"SiNeRF {W}: the kernels' route did not resolve on the "
                 "card")
        model = make_model(scfg, torch.bfloat16,
                           torch.Generator().manual_seed(6), dev)
        state = None

        def run_siren():
            nonlocal state
            state = train(model, scfg, pool, scene, logger=ListLogger(),
                          log_every=WIDTH_ROUTE_STEPS)
            cli.evaluate_split(model, og.conservative(state.grid), held,
                               scfg, device=dev)

        names = ("siren_fwd_ws_kernel", "siren_bwd_rows_ws_kernel",
                 "siren_march_kernel")
        if kr.stream_width(W):
            names, plain = (), tuple(f"{n.replace('_ws', '')}_stream"
                                     for n in names)
        else:
            plain = ()
        before = launch_counts()
        with ModuleCalls() as calls:
            require_kernels(
                f"2b. {WIDTH_ROUTE_STEPS} SiNeRF train steps and a held-out "
                f"view at 8 x {W}", run_siren, names, W,
                plain=plain + SIREN_BWD_PARTS[1:])
        after = launch_counts()
        siren_wide[W] = {k: after[k] - before[k] for k in after}
        print(f"2b. SiNeRF {W}: module calls {calls.calls} on the MLP, "
              f"{calls.density_calls} for the grid refresh's densities")
        if calls.calls:
            fail(f"SiNeRF {W}: the run called the SiNeRF module "
                 f"{calls.calls} times on the MLP")
    return wide, siren_wide


def wide_shapes(width: int, wmax: bool) -> dict:
    """The rows phase 19 runs a width's kernels on: the main path's
    (phase 3's march inputs, one validation chunk for kernel 3, one
    og.update launch for kernel 4, TRAIN_ROWS for kernels 5-8), the plain
    versions on the same rows; at W_max (`wmax`) one ray block per SM
    (`ray_blocks`: phase 3's first rays, the plain marches on the first
    block), WMAX_ROWS rows for kernels 3-8 and WMAX_PLAIN_ROWS of them for
    the plain versions. `quick`: the kernel calls of in_turns(quick=...)
    (above 256 WIDE_KERNEL_REPS, at W_max one; 0: in turns);
    `module_reps`: the bf16 module's calls (MODULE_REPS_WIDE above 256,
    else 3; at W_max 0: one call, cuda_ms)."""
    quick = WIDE_KERNEL_REPS if width > 256 else 0
    if wmax:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return dict(ray_blocks=sms, mlp=WMAX_ROWS, density=WMAX_ROWS,
                    train=WMAX_ROWS, plain=WMAX_PLAIN_ROWS, quick=1,
                    module_reps=0)
    return dict(ray_blocks=None, mlp=VAL_CHUNK_ROWS, density=262_144,
                train=TRAIN_ROWS, plain=None, quick=quick,
                module_reps=MODULE_REPS_WIDE if quick else 3)


def seeded_model(cfg, seed: int, dev, on_card: bool = False):
    """cfg's bf16 model with weights from `seed`: drawn on the host (the
    same weights on every device), or with `on_card` on the card's own
    generator (W_max's ~2^31 weights take ~25 s to draw on the host)."""
    from fsnerf_tpu_torch.core.models import make_model

    if not on_card:
        return make_model(cfg, torch.bfloat16,
                          torch.Generator().manual_seed(seed), dev)
    with torch.device(dev):
        return make_model(cfg, torch.bfloat16,
                          torch.Generator(device=dev).manual_seed(seed), dev)


def nerf_width_case(cfg, dev, march_in, module=False, wmax=False):
    """19a: kernels 1 and 3-6 of a NeRF of cfg's architecture (seeded
    weights) against their plain versions at the main path's shapes, each
    bitwise repeatable (kernel 6 in both modes, recompute bitwise saved),
    each launch counted from 0; at W_max (`wmax`) on wide_shapes' rows,
    the forward kernels' plain comparison on the first rows of the same
    launch, kernel 6's on a launch of those rows. Returns (width packed,
    {kernel: (ms, plain ms, bound dict, max err)}, launches, {kernel: the
    bf16 module's ms on the same rows} with `module`, else {}, the shapes
    run)."""
    from fsnerf_tpu_torch.core.encoding import positional_encoding
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    L, skip = cfg.model.n_layers, cfg.model.skip
    nf, nfv = cfg.encoder.n_freqs, cfg.encoder.n_freqs_views
    W = cfg.model.d_filter
    shapes = wide_shapes(W, wmax)
    quick = shapes["quick"]
    model = seeded_model(cfg, 7, dev, wmax)
    sd = model.state_dict()
    out = {}
    kr.ray_march.launches = km.nerf_mlp.launches = 0
    km.nerf_density.launches = mt.mlp_train_fwd.launches = 0
    mt.mlp_train_bwd.launches = 0

    # kernel 1 on phase 3's padded march inputs (at W_max one ray block per
    # SM)
    padded, bR, cs = march_in
    plain_rays = None
    if shapes["ray_blocks"] is not None:
        padded = tuple(a[:shapes["ray_blocks"] * bR].contiguous()
                       for a in padded)
        plain_rays = bR
    rp = kr.prep_params(sd, L, skip, nf, nfv, device=dev)
    r = compare(f"19a. width {W} (packed {rp.width}), n_freqs {nf}/{nfv}: "
                f"march", kr.ray_march, kr.ray_march_reference, padded, rp,
                bR, cs, cfg.sampling.early_stop_eps, quick=quick,
                plain_rays=plain_rays)
    again = kr.ray_march(*padded, rp, bR, cs, cfg.sampling.early_stop_eps)
    if not all(torch.equal(a, b) for a, b in zip(r.pop("first"), again)):
        fail(f"19a. width {W}: two march runs differ")
    out["ray_march"] = (r["ms"], r["plain_ms"], bound(
        2.0 * mlp_macs(cfg) * r["executed"] * bR * cs,
        nbytes(*padded, rp.wpack, rp.bpack, rp.enc)
        + padded[0].shape[0] * (8 + 1 / bR) * 4), r["max_abs_err"])
    packed = rp.width
    del rp, again

    g = torch.Generator(device=dev).manual_seed(8)
    n = shapes["mlp"]
    x = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    module_ms = {}
    if module:
        # the nearest cuBLAS route: the bf16 module on each kernel's rows
        # (the march's: every sample of the march inputs, as module_routes)
        reps = shapes["module_reps"]
        module_ms = module_routes(cfg, dev, padded, model,
                                  shapes["train"], reps)
        with torch.no_grad():
            module_ms["nerf_mlp"] = cuda_ms(lambda: model(x, d), reps)
            module_ms["nerf_density"] = cuda_ms(
                lambda: model(x[:shapes["density"]]), reps)
        torch.cuda.empty_cache()
    # kernels 3 and 4: one validation chunk, one og.update launch's rows
    p = km.prep_params(sd, L, skip, dev)
    ex = km.pad_features(positional_encoding(x, nf, True), p.d_enc_pad)
    ed = km.pad_features(positional_encoding(d, nfv, True), p.d_dir_pad)
    npl = shapes["plain"] or n
    got = km.nerf_mlp(ex, ed, p)
    ref = km.nerf_mlp_reference(ex[:npl].contiguous(), ed[:npl].contiguous(),
                                p)
    rgb_err = float((got[:npl, :3] - ref[:, :3]).abs().max())
    sig = float((got[:npl, 3] - ref[:, 3]).abs().max()) / (
        float(ref[:, 3].abs().max()) + 1e-9)
    if not torch.isfinite(got).all() or rgb_err > MLP_RGB_TOL or \
            sig > MLP_SIGMA_TOL:
        fail(f"19a. width {W}: nerf_mlp vs plain rgb {rgb_err:.3e}, sigma "
             f"{sig:.3e} of max")
    if not torch.equal(got, km.nerf_mlp(ex, ed, p)):
        fail(f"19a. width {W}: two nerf_mlp runs differ")
    ms, plain_ms = in_turns(
        lambda: km.nerf_mlp_reference(ex[:npl], ed[:npl], p),
        lambda: km.nerf_mlp(ex, ed, p), quick=quick)
    out["nerf_mlp"] = (ms, plain_ms, bound(2.0 * mlp_macs(cfg) * n, nbytes(
        ex, ed, p.wpack, p.bpack, got)), max(rgb_err, sig))
    nd = shapes["density"]
    exd = ex[:nd].contiguous()
    got = km.nerf_density(exd, p)
    ref = km.nerf_density_reference(exd[:npl].contiguous(), p)
    sig = float((got[:npl] - ref).abs().max()) / (
        float(ref.abs().max()) + 1e-9)
    if not torch.isfinite(got).all() or sig > DENSITY_SIGMA_TOL:
        fail(f"19a. width {W}: nerf_density vs plain sigma {sig:.3e} of max")
    if not torch.equal(got, km.nerf_density(exd, p)):
        fail(f"19a. width {W}: two nerf_density runs differ")
    ms, plain_ms = in_turns(lambda: km.nerf_density_reference(exd[:npl], p),
                            lambda: km.nerf_density(exd, p), quick=quick)
    out["nerf_density"] = (ms, plain_ms, bound(
        2.0 * density_macs(cfg) * nd, nbytes(exd, p.wpack, p.bpack, got)),
        sig)
    del p, ex, ed, exd, got, ref

    # kernels 5 and 6 at the train step's rows
    n = shapes["train"]
    xt, dt = x[:n].contiguous(), d[:n].contiguous()
    target = torch.cat([torch.rand((n, 3), generator=g, device=dev),
                        torch.zeros((n, 1), device=dev)], dim=-1)
    lay = mt.TrainLayout.from_config(cfg)
    tp = mt.pack_train_params(sd, lay, kr.enc_table(nf, nfv, device=dev))
    del model, sd
    torch.cuda.empty_cache()
    fo, acts = mt.mlp_train_fwd(xt, dt, tp, save_acts=True)
    xp, dp = xt[:npl].contiguous(), dt[:npl].contiguous()
    fr, racts = mt.mlp_train_fwd_reference(xp, dp, tp, save_acts=True)
    rgb_err = float((fo[:npl, :3] - fr[:, :3]).abs().max())
    sig = float((fo[:npl, 3] - fr[:, 3]).abs().max()) / (
        float(fr[:, 3].abs().max()) + 1e-9)
    if not torch.isfinite(fo).all() or rgb_err > TRAIN_RGB_TOL or \
            sig > TRAIN_SIGMA_TOL:
        fail(f"19a. width {W}: train forward vs plain rgb {rgb_err:.3e}, "
             f"sigma {sig:.3e} of max")
    again = mt.mlp_train_fwd(xt, dt, tp, save_acts=True)
    if not (torch.equal(fo, again[0]) and torch.equal(acts, again[1])):
        fail(f"19a. width {W}: two train forward runs differ")
    del again
    ms, plain_ms = in_turns(
        lambda: mt.mlp_train_fwd_reference(xp, dp, tp, True),
        lambda: mt.mlp_train_fwd(xt, dt, tp, True), quick=quick)
    weights = (tp.wpack, tp.bpack, tp.enc)
    out["mlp_train_fwd"] = (ms, plain_ms, bound(
        2.0 * mlp_macs(cfg) * n, nbytes(xt, dt, *weights, fo, acts)),
        max(rgb_err, sig))
    # the MSE cotangent of the kernel's rows (the plain version's where it
    # has them all)
    dout = (2.0 * ((fr if npl == n else fo) - target) / fo.numel()
            ).contiguous()
    saved = mt.mlp_train_bwd(xt, dt, dout, tp, acts)
    if not all(torch.equal(a, b) for a, b in zip(
            saved, mt.mlp_train_bwd(xt, dt, dout, tp, acts))):
        fail(f"19a. width {W}: two train backward runs differ")
    if not all(torch.equal(a, b) for a, b in zip(
            saved, mt.mlp_train_bwd(xt, dt, dout, tp, None))):
        fail(f"19a. width {W}: saved-acts and recompute gradients differ")
    bwd_bound = bound(2.0 * bwd_macs(cfg) * n, nbytes(
        xt, dt, dout, acts, *weights, *saved))
    del saved
    if npl < n:                      # the plain comparison's own launch
        ms = cuda_ms(lambda: mt.mlp_train_bwd(xt, dt, dout, tp, acts),
                     quick)
        del acts
        fo, acts = mt.mlp_train_fwd(xp, dp, tp, save_acts=True)
        dout = (2.0 * (fr - target[:npl]) / fr.numel()).contiguous()
        xt, dt = xp, dp
    grads = mt.mlp_train_bwd(xt, dt, dout, tp, acts)
    plain = mt.mlp_train_bwd_reference(xt, dt, dout, tp, racts)
    worst = max((float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30),
                 name) for name, a, b in zip(
        lay.param_names, lay.grads_from_packed(*grads),
        lay.grads_from_packed(*plain)))
    del plain
    from fsnerf_tpu_torch.scripts.grad_arbiter import nerf_arbiter

    rows = xt.shape[0]
    verdict = gradient_verdict(
        f"19a. width {W}: train backward vs plain", W, worst, nerf_arbiter,
        lay, grads, lambda: mt.mlp_train_bwd_reference(
            xt, dt, dout, tp, acts[:rows]), xt, dt, dout, tp, acts[:rows])
    del grads
    if npl < n:
        plain_ms = once_ms(lambda: mt.mlp_train_bwd_reference(
            xt, dt, dout, tp, racts))
    else:
        ms, plain_ms = in_turns(
            lambda: mt.mlp_train_bwd_reference(xt, dt, dout, tp, racts),
            lambda: mt.mlp_train_bwd(xt, dt, dout, tp, acts), quick=quick)
    out["mlp_train_bwd"] = (ms, plain_ms, bwd_bound, worst[0])
    print(f"19a. width {W}: the train backward's {verdict}")
    del tp, fo, fr, acts, racts
    torch.cuda.synchronize()
    launches = {"ray_march": kr.ray_march.launches,
                "nerf_mlp": km.nerf_mlp.launches,
                "nerf_density": km.nerf_density.launches,
                "mlp_train_fwd": mt.mlp_train_fwd.launches,
                "mlp_train_bwd": mt.mlp_train_bwd.launches}
    if min(launches.values()) == 0:
        fail(f"19a. width {W}: a kernel never launched: {launches}")
    torch.cuda.empty_cache()
    return packed, out, launches, module_ms, shapes


def siren_width_case(cfg, dev, march_in, module=False, packed=None,
                     wmax=False):
    """19b: kernels 7, 8 (saved and recompute) and 2 of a SiNeRF of cfg's
    width against their plain versions (196,608 rows; phase 3's march
    inputs; at W_max, `wmax`, wide_shapes' rows, the plain versions on
    the first rows of the same launch, kernel 8's on a launch of those
    rows), each bitwise repeatable and each launch counted from 0, and each
    timed in both of its modes (kernel 7 with and without acts, kernel 8
    saved and recompute); a kernel that refuses the packed width a
    ValueError naming its limit and no launch. `packed`: pack at this width
    instead of kernel_width's (320 reaches the mma.sync forward and march).
    Returns (width packed, {kernel or "kernel (mode)": (ms, plain ms, bound
    dict, max err)}, launches, refused, {the same keys: the bf16 SiNeRF
    module's ms on the same rows} with `module`, else {}, the shapes
    run)."""
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.ops.volrend import volume_render

    L, W = cfg.model.n_layers, cfg.model.d_filter
    shapes = wide_shapes(W, wmax)
    quick = shapes["quick"]
    model = seeded_model(cfg, 9, dev, wmax)
    if packed is None:
        params = ks.prep_siren_params(model.state_dict(), L,
                                      with_transposed=True)
    else:
        params = ks._prep_siren_params(model.state_dict(), L, None, True,
                                       None, packed)
    K = params.layout.width
    g = torch.Generator(device=dev).manual_seed(10)
    n = shapes["train"]
    npl = shapes["plain"] or n
    x = torch.rand((n, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=g, device=dev), dim=-1)
    target = torch.cat([torch.rand((n, 3), generator=g, device=dev),
                        torch.zeros((n, 1), device=dev)], dim=-1)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    xq, dq = xp[:npl].contiguous(), dp[:npl].contiguous()
    padded, bR, cs = march_in
    plain_rays = None
    if shapes["ray_blocks"] is not None:
        padded = tuple(a[:shapes["ray_blocks"] * bR].contiguous()
                       for a in padded)
        plain_rays = bR
    module_ms = {}
    if module:
        # the nearest cuBLAS route: the bf16 SiNeRF module on each kernel's
        # rows (the march's: every sample of the march inputs, with
        # volume_render; from 1024 up in W // 512 pieces of rays, as its
        # f32 activations of every sample at once outgrow the card), before
        # the kernels' acts streams (6.4 GB each at 1024) exist
        reps = shapes["module_reps"]
        xm, dirs, t, deltas, mask = padded
        m_params = list(model.parameters())
        pieces = torch.arange(xm.shape[0], device=dev).chunk(max(1, W // 512))
        with torch.no_grad():
            def module_march():
                o = torch.cat([model(xm[p], dirs[p, None, :].expand(
                    xm[p].shape)).float() for p in pieces])
                volume_render(o[..., 3], o[..., :3], t, deltas, mask > 0)

            module_ms["siren_ray_march"] = cuda_ms(module_march, reps)
            module_ms["siren_mlp_fwd"] = cuda_ms(lambda: model(x, d), reps)
        m_out = model(x, d).float()
        module_ms["siren_mlp_bwd"] = cuda_ms(lambda: torch.autograd.grad(
            m_out, m_params, torch.full_like(m_out, 1.0 / m_out.numel()),
            retain_graph=True), reps)
        del m_out, m_params
    del model
    torch.cuda.empty_cache()
    ks.siren_mlp_fwd.launches = ks.siren_mlp_bwd.launches = 0
    kr.siren_ray_march.launches = 0
    out, refused = {}, []

    def refuses(name, fn):
        try:
            fn()
        except ValueError as e:
            if "widths up to" not in str(e):
                raise
            refused.append(name)
            return True
        return False

    fo = acts = None
    if not refuses("siren_mlp_fwd",
                   lambda: ks.siren_mlp_fwd(xq, dq, params, True)):
        fo, acts = ks.siren_mlp_fwd(xp, dp, params, True)
        fo2, acts2 = ks.siren_mlp_fwd(xp, dp, params, True)
        same = torch.equal(fo, fo2) and torch.equal(acts, acts2)
        del fo2, acts2
        fr, _ = ks.siren_mlp_fwd_reference(xq, dq, params)
        rgb_err = float((fo[:npl, :3] - fr[:, :3]).abs().max())
        sig = float((fo[:npl, 3] - fr[:, 3]).abs().max()) / (
            float(fr[:, 3].abs().max()) + 1e-9)
        primal, _ = ks.siren_mlp_fwd(xp, dp, params)
        if not torch.isfinite(fo).all() or rgb_err > MLP_RGB_TOL or \
                sig > MLP_SIGMA_TOL:
            fail(f"19b. SiNeRF width {W}: forward vs plain rgb "
                 f"{rgb_err:.3e}, sigma {sig:.3e} of max")
        if not (same and torch.equal(primal, fo)):
            fail(f"19b. SiNeRF width {W}: two forward runs differ (or the "
                 "forward without acts from the one with)")
        del primal
        ms, plain_ms = in_turns(
            lambda: ks.siren_mlp_fwd_reference(xq, dq, params, True),
            lambda: ks.siren_mlp_fwd(xp, dp, params, True), quick=quick)
        out["siren_mlp_fwd"] = (ms, plain_ms, bound(
            2.0 * siren_macs(L, W) * n, nbytes(xp, dp, params.wpack,
                                               params.bpack, fo, acts)),
            max(rgb_err, sig))
        ms, plain_ms = in_turns(
            lambda: ks.siren_mlp_fwd_reference(xq, dq, params),
            lambda: ks.siren_mlp_fwd(xp, dp, params), quick=quick)
        out["siren_mlp_fwd (no acts)"] = (ms, plain_ms, bound(
            2.0 * siren_macs(L, W) * n, nbytes(xp, dp, params.wpack,
                                               params.bpack, fo)),
            max(rgb_err, sig))
        # the MSE cotangent of the kernel's rows (the plain version's where
        # it has them all)
        dout = (2.0 * ((fr if npl == n else fo) - target) / fo.numel()
                ).contiguous()
        if not refuses("siren_mlp_bwd", lambda: ks.siren_mlp_bwd(
                xq, dq, dout[:npl].contiguous(), params, acts[:npl])):
            lay = params.layout
            modes = {}
            for mode, a in (("saved", acts), ("recompute", None)):
                gk = ks.siren_mlp_bwd(xp, dp, dout, params, a)
                if not all(torch.equal(u, v) for u, v in zip(
                        gk, ks.siren_mlp_bwd(xp, dp, dout, params, a))):
                    fail(f"19b. SiNeRF width {W}: two backward ({mode}) "
                         "runs differ")
                modes[mode] = gk
                if mode == "saved":
                    bounds = bound(2.0 * siren_bwd_macs(L, W) * n, nbytes(
                        xp, dp, dout, acts, params.wpack, params.bpack,
                        params.wtpack, *gk))
                else:
                    # from the inputs alone: the trunk's forward again
                    bounds = bound(2.0 * (siren_bwd_macs(L, W) + 3 * W
                                          + (L - 1) * W * W) * n,
                                   nbytes(xp, dp, dout, params.wpack,
                                          params.bpack, params.wtpack, *gk))
                key = ("siren_mlp_bwd" if mode == "saved"
                       else "siren_mlp_bwd (recompute)")
                out[key] = [cuda_ms(lambda: ks.siren_mlp_bwd(
                    xp, dp, dout, params, a), quick or 10), None, bounds,
                    None]
            if K in kr.SPLIT_WIDTHS or kr.stream_width(K):
                if not all(torch.equal(u, v) for u, v in zip(
                        modes["saved"], modes["recompute"])):
                    fail(f"19b. SiNeRF width {W}: recompute mode differs "
                         "from saved mode at a split or streamed width")
            del modes, gk
            if npl < n:        # the plain comparison's own launches
                del acts
                fo, acts = ks.siren_mlp_fwd(xq, dq, params, True)
                dout = (2.0 * (fr - target[:npl]) / fr.numel()).contiguous()
            racts = ks.siren_mlp_fwd_reference(xq, dq, params, True)[1]
            from fsnerf_tpu_torch.scripts.grad_arbiter import siren_arbiter

            for mode, a, ra in (("saved", acts, racts),
                                ("recompute", None, None)):
                gk = ks.siren_mlp_bwd(xq, dq, dout, params, a)
                gp = ks.siren_mlp_bwd_reference(xq, dq, dout, params, ra)
                worst = max((float((u - v).abs().max())
                             / (float(v.abs().max()) + 1e-30), name)
                            for name, u, v in zip(
                                lay.param_names, lay.grads_from_packed(*gk),
                                lay.grads_from_packed(*gp)))
                del gp
                # recompute mode: from its own bf16 acts (the saved mode's,
                # bitwise, from 384 up) or, up to 256, its f32 factors,
                # which the arbiter does not model (kept to GRAD_TOL)
                verdict = gradient_verdict(
                    f"19b. SiNeRF width {W}: backward ({mode}) vs plain",
                    W if mode == "saved" else min(W, 1024), worst,
                    siren_arbiter, lay, gk, lambda: ks.siren_mlp_bwd_reference(
                        xq, dq, dout, params, acts[:npl]),
                    xq, dq, dout, params, acts[:npl])
                del gk
                print(f"19b. SiNeRF width {W}: the backward's ({mode}) "
                      f"{verdict}")
                key = ("siren_mlp_bwd" if mode == "saved"
                       else "siren_mlp_bwd (recompute)")
                if quick:
                    plain_ms = once_ms(lambda: ks.siren_mlp_bwd_reference(
                        xq, dq, dout, params, ra))
                else:
                    out[key][0], plain_ms = in_turns(
                        lambda: ks.siren_mlp_bwd_reference(xq, dq, dout,
                                                           params, ra),
                        lambda: ks.siren_mlp_bwd(xq, dq, dout, params, a))
                out[key][1], out[key][3] = plain_ms, worst[0]
                out[key] = tuple(out[key])
            del racts
        del fr
    if not refuses("siren_ray_march", lambda: kr.siren_ray_march(
            *padded, params, bR, cs)):
        r = compare(f"19b. SiNeRF width {W} (packed {K}): march",
                    kr.siren_ray_march, kr.siren_ray_march_reference, padded,
                    params, bR, cs, cfg.sampling.early_stop_eps, quick=quick,
                    plain_rays=plain_rays)
        again, _ = kr.siren_ray_march(*padded, params, bR, cs,
                                      cfg.sampling.early_stop_eps)
        if not torch.equal(r.pop("first")[0], again):
            fail(f"19b. SiNeRF width {W}: two march runs differ")
        out["siren_ray_march"] = (r["ms"], r["plain_ms"], bound(
            2.0 * siren_macs(L, W) * r["executed"] * bR * cs,
            nbytes(*padded, params.wpack, params.bpack)
            + padded[0].shape[0] * (8 + 1 / bR) * 4), r["max_abs_err"])
    torch.cuda.synchronize()
    launches = {"siren_mlp_fwd": ks.siren_mlp_fwd.launches,
                "siren_mlp_bwd": ks.siren_mlp_bwd.launches,
                "siren_ray_march": kr.siren_ray_march.launches}
    for name in {k.split(" ")[0] for k in out}:
        if launches[name] == 0:
            fail(f"19b. SiNeRF width {W}: {name} never launched")
    for name in refused:
        if launches[name]:
            fail(f"19b. SiNeRF width {W}: {name} refused yet launched")
    for k in out if module_ms else ():
        module_ms[k] = module_ms[k.split(" ")[0]]
    del params, fo, acts
    torch.cuda.empty_cache()
    return K, out, launches, refused, module_ms, shapes


def arbiter_errors(arbiter, lay, grads, plain, *args):
    """(the kernel's worst gradient error, the plain version's) against a
    float64 arbiter of scripts/grad_arbiter.py (`arbiter`: nerf_arbiter or
    siren_arbiter, called with args), each over every gradient tensor
    relative to the arbiter's max."""
    dw, db, _ = arbiter(*args)
    arb = lay.grads_from_packed(dw, db)
    del dw, db

    def worst(got):
        return max(float((g - a).abs().max() / (a.abs().max() + 1e-30))
                   for g, a in zip(lay.grads_from_packed(*got), arb))

    return worst(grads), worst(plain)


def gradient_verdict(phase, W, worst, arbiter, lay, grads, plain_fn,
                     *args) -> str:
    """Fail unless the gradients' worst error against the plain version
    (`worst`: (error, tensor)) is within GRAD_TOL or, above width 1024,
    within ARBITER_FACTOR of the plain version's against the float64
    arbiter; plain_fn gives the plain version's gradients from the
    kernel's saved activations. Returns what decided."""
    if worst[0] <= GRAD_TOL:
        return f"worst gradient {worst[0]:.3e} of its max ({worst[1]})"
    if W <= 1024:
        fail(f"{phase}: {worst[1]} off by {worst[0]:.3e} of its max")
    k, p = arbiter_errors(arbiter, lay, grads, plain_fn(), *args)
    if k > ARBITER_FACTOR * p:
        fail(f"{phase}: {worst[1]} off by {worst[0]:.3e} of its max; "
             f"against the float64 arbiter the kernel {k:.3e}, the plain "
             f"version {p:.3e} (over {ARBITER_FACTOR}x)")
    return (f"worst gradient {worst[0]:.3e} of its max ({worst[1]}) against "
            f"the plain version; against the float64 arbiter the kernel "
            f"{k:.3e}, the plain version {p:.3e} (ratio {k / p:.2f}, within "
            f"{ARBITER_FACTOR}x)")


def nerf_max_width(cfg) -> int:
    """W_max of cfg's NeRF architecture: the widest streamed width whose
    packed weights int32 offsets address (render.py)."""
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    m, e = cfg.model, cfg.encoder
    return kr.widest_stream_width(lambda W: mt.TrainLayout.of_module(
        m.n_layers, m.skip, W, e.n_freqs, e.n_freqs_views).n_w)


def shapes_line(shapes) -> str:
    rays = ("phase 3's rays" if shapes["ray_blocks"] is None
            else f"the first {shapes['ray_blocks']} ray blocks of phase 3's "
            "rays (the plain march on the first)")
    plain = ("the plain versions on the same rows" if shapes["plain"] is None
             else f"the plain versions on {shapes['plain']} of those rows")
    return (f"march on {rays}, kernel 3 at {shapes['mlp']} rows, kernel 4 "
            f"at {shapes['density']}, the train kernels at "
            f"{shapes['train']}, {plain}; timing "
            + (f"kernel over {shapes['quick']} calls, plain version one "
               "call" if shapes["quick"] else "in turns"))


def width_line(out, module_ms=None) -> str:
    return "; ".join(
        f"{k} {v[0]:.3f} ms (plain {v[1]:.3f}, "
        + (f"bf16 module {module_ms[k]:.3f}, " if module_ms else "")
        + f"bound {v[2]['bound_ms']:.3f} by {v[2]['bound_by']}, share "
        f"{v[2]['bound_ms'] / v[0]:.3f}, err {v[3]:.2e})"
        for k, v in out.items())


def width_kernels(cfg, dev, card, log, march_in):
    """Phase 19a-b: the kernels at widths that are not their own, and width
    192 in each (ptxas lines of every 192 instance). Returns (the 19a
    numbers of the NeRF kernels at NERF_REPORT_WIDTHS, by packed width:
    {kernel: (ms, plain ms, bound dict, max err)}, the 19b numbers of the
    SIREN kernels at SIREN_REPORT_WIDTHS the same way: the report's wide
    instances)."""
    from fsnerf_tpu_torch.ops.kernels import siren as ks
    from fsnerf_tpu_torch.train import step

    from fsnerf_tpu_torch.ops.kernels import render as kr

    nerf_wide = {}
    top = nerf_max_width(cfg)
    for W, enc in WIDTH_NERF + ((top, {}),):
        wcfg = width_cfg(cfg, W, **enc)
        K, out, launches, module_ms, shapes = nerf_width_case(
            wcfg, dev, march_in, module=True, wmax=W == top)
        print(f"19a. NeRF 8 x {W} (packed {K}), n_freqs "
              f"{wcfg.encoder.n_freqs}/{wcfg.encoder.n_freqs_views} on "
              f"{card}: {width_line(out, module_ms)}; launches {launches}; "
              f"bitwise repeatable, recompute bitwise saved; "
              f"{shapes_line(shapes)}")
        if K in NERF_REPORT_WIDTHS and not enc:
            nerf_wide.setdefault(K, out)
    print("19a. the width-384 and 512 instances and kernel 6's 64-row row "
          "pass:\n" + "\n".join(
              line for name, widths in (
                  ("nerf_march_kernel", kr.SPLIT_WIDTHS),
                  ("nerf_mlp_kernel", kr.SPLIT_WIDTHS),
                  ("nerf_density_kernel", kr.SPLIT_WIDTHS),
                  ("mlp_train_fwd_kernel", kr.SPLIT_WIDTHS),
                  ("mlp_train_bwd_rows_kernel", (64,)))
              for line in ptxas_of(log, name).splitlines()
              if any(f"{name}<{w}>" in line for w in widths)
              and ("Used" in line or "spill stores" in line)))
    print("19a. the streamed instances (768 and every multiple of 256 "
          "up):\n" + "\n".join(
        line for name in ("nerf_march_kernel_stream", "nerf_mlp_kernel_stream",
                          "nerf_density_kernel_stream",
                          "mlp_train_fwd_kernel_stream",
                          "mlp_train_bwd_rows_kernel_stream")
        for line in ptxas_of(log, name).splitlines()
        if "Used" in line or "spill stores" in line))
    siren_widths = kr.NERF_KERNEL_WIDTHS + (768, 1024, 1280, 2048,
                                            ks.siren_max_width(8))
    stages = {k: [(ks.siren_stages(W, k), ks.launcher_stages(W, k))
                  for W in siren_widths]
              for k in ("forward", "march", "backward")}
    print("19b. the SIREN kernels' ring stages (the C launchers', "
          "siren.py::siren_stages mirroring them): " + "; ".join(
              f"{k} " + ", ".join(f"{W}: {c}" for W, (_, c) in zip(
                  siren_widths, v)) for k, v in stages.items()))
    if any(p != c for v in stages.values() for p, c in v):
        fail(f"19b. siren.py::siren_stages differs from the launchers' "
             f"rings (Python, C): {stages}")
    wide = {}
    top = ks.siren_max_width(cfg.model.n_layers)
    for W in WIDTH_SIREN + (top,):
        scfg = sinerf_config(width_cfg(cfg, W))
        K, out, launches, refused, module_ms, shapes = siren_width_case(
            scfg, dev, march_in, module=True, wmax=W == top)
        print(f"19b. SiNeRF 8 x {W} (packed {K}) on {card}: "
              f"{width_line(out, module_ms)}; launches {launches}; "
              f"bitwise repeatable; {shapes_line(shapes)}")
        if refused or {k.split(" ")[0] for k in out} != set(launches):
            fail(f"19b. SiNeRF width {W}: refused {refused}, ran "
                 f"{list(out)}")
        if K in SIREN_REPORT_WIDTHS:
            wide[K] = out
    # 320 packed at 320: the mma.sync forward and march (siren_fwd_kernel,
    # ray_march_kernel<SirenMarch>), which kernel_width no longer packs at,
    # held the same way; the backward refuses by name (the mma.sync row
    # pass's shared memory)
    scfg = sinerf_config(width_cfg(cfg, 320))
    K, out, launches, refused, _, _ = siren_width_case(scfg, dev, march_in,
                                                       packed=320)
    print(f"19b. SiNeRF 8 x 320 (packed {K}, the mma.sync forward and "
          f"march) on {card}: {width_line(out)}; launches {launches}; "
          f"refused by name {refused}; bitwise repeatable")
    if refused != ["siren_mlp_bwd"] or \
            {k.split(" ")[0] for k in out} != {"siren_mlp_fwd",
                                              "siren_ray_march"}:
        fail(f"19b. SiNeRF 320 packed at 320: refused {refused}, ran "
             f"{list(out)}")
    # past W_max: the SIREN kernels refuse a SiNeRF by name (its packed
    # weights' int32 offsets), and so do the NeRF ones; the run takes the
    # printed module route. SiNeRF and NeRF 512, 600, 1024, 1100 and 2048
    # resolve to the kernels.
    over = {"SiNeRF": sinerf_config(width_cfg(cfg, top + 1)),
            "NeRF": width_cfg(cfg, nerf_max_width(cfg) + 1)}
    lines = {}
    for name, ocfg in over.items():
        lines[name] = step.report_module_route(ocfg, dev)
        if lines[name] is None or "W_max" not in lines[name] or \
                step.resolve_fused_kernel(ocfg, dev):
            fail(f"{name} {ocfg.model.d_filter} did not take the printed "
                 f"module route: {lines[name]}")
    if ks.siren_kernel_error(kr.kernel_width(top + 1), "forward") is None:
        fail(f"the SIREN forward takes width {kr.kernel_width(top + 1)}")
    for W in (512, 600, 1024, 1100, 2048):
        for name, ccfg in ((f"SiNeRF {W}", sinerf_config(width_cfg(cfg, W))),
                           (f"NeRF {W}", width_cfg(cfg, W))):
            line_k = step.report_module_route(ccfg, dev)
            if line_k is not None or not step.resolve_fused_kernel(ccfg,
                                                                    dev):
                fail(f"{name} did not resolve to the kernels: {line_k}")
    print(f"19b. past W_max (SiNeRF {top}, NeRF {nerf_max_width(cfg)}: "
          f"the packed weights' int32 offsets) the route prints: "
          f"{lines['SiNeRF']}; {lines['NeRF']}; SiNeRF and NeRF 512, 600, "
          "1024, 1100 and 2048 resolve to the kernels")
    print("19b. the width-192 instances:\n" + "\n".join(
        line for name in ("nerf_march_kernel", "nerf_mlp_kernel",
                          "nerf_density_kernel", "mlp_train_fwd_kernel",
                          "siren_fwd_ws_kernel", "siren_march_kernel",
                          "siren_bwd_rows_ws_kernel")
        for line in ptxas_of(log, name).splitlines() if "<192" in line))
    split = [line for name in ("siren_fwd_ws_kernel", "siren_march_kernel",
                               "siren_bwd_rows_ws_kernel")
             for line in ptxas_of(log, name).splitlines()
             if any(f"{name}<{w}" in line for w in kr.SPLIT_WIDTHS)]
    print("19b. the SIREN instances at 384 and 512:\n" + "\n".join(split))
    spills = [line for line in split if re.search(
        r"[1-9]\d* bytes spill (stores|loads)", line)]
    if len(split) != 2 * 2 * 4 or spills:
        fail(f"19b. the SIREN instances at 384 and 512: {len(split)} ptxas "
             f"lines, spilling: {spills}")
    streamed = [line for name in ("siren_fwd_kernel_stream",
                                  "siren_march_kernel_stream",
                                  "siren_bwd_rows_kernel_stream")
                for line in ptxas_of(log, name).splitlines()
                if "Used" in line or "spill stores" in line]
    print("19b. the streamed SIREN instances (768 and every multiple of "
          "256 up):\n"
          + "\n".join(streamed))
    spills = [line for line in streamed if re.search(
        r"[1-9]\d* bytes spill (stores|loads)", line)]
    if len(streamed) != 2 * 4 or spills:
        fail(f"19b. the streamed SIREN instances: {len(streamed)} ptxas "
             f"lines, spilling: {spills}")
    return nerf_wide, wide


def release_memory():
    """Collect what a training slice left (its model, state and CUDA
    graphs, whose pools hold their memory between replays, once the caller
    dropped them) before the next run: at 8 x 1536 the SiNeRF module
    route's eval outgrows the card beside them."""
    gc.collect()
    torch.cuda.empty_cache()


def width_train_slices(cfg, dev, card):
    """Phase 19c: the occgrid training slice (WIDTH_TRAIN's graphed steps,
    the 8-view 128x128 sphere, then the held-out views) at 8 x 192, 8 x 200
    (packed at 256), 8 x 512 (the column-split kernels), 8 x 1024 and 8 x
    2048 (the streamed kernels) through the kernels, launch counts set to 0
    before and read after, no NeRF module call; then the same run through
    the module (cfg.model.fused_kernel and fused_render off: the route
    these widths took before the kernels took them): steps/s over the whole
    run and from step 100 on and held-out PSNR side by side, at 512 and
    1024 within WIDE_PSNR_TOL_DB, at 2048 within WIDEST_PSNR_TOL_DB."""
    import dataclasses

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import mlp as km
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    held = cli.split_of(scene.holdout(n=3, seed=101))
    for W, steps in WIDTH_TRAIN.items():
        kcfg = train_slice_config(width_cfg(cfg, W))
        kcfg = kcfg.replace(train=dataclasses.replace(kcfg.train,
                                                      n_iters=steps))
        mcfg = kcfg.replace(model=dataclasses.replace(
            kcfg.model, fused_kernel=False, fused_render=False))
        untrained = make_model(kcfg, torch.bfloat16,
                               torch.Generator().manual_seed(0), dev)
        base, _ = cli.evaluate_split(
            untrained, og.conservative(cli.rebuild_grid(
                untrained, kcfg, scene.aabb, dev)), held, kcfg, device=dev)
        res = {}
        for route, tcfg in (("kernels", kcfg), ("module", mcfg)):
            kr.ray_march.launches = km.nerf_density.launches = 0
            mt.mlp_train_fwd.launches = mt.mlp_train_bwd.launches = 0
            with ModuleCalls() as calls:
                model, state, log, _, train_s, rungs, _ = run_train_slice(
                    tcfg, dev)
                got, _ = cli.evaluate_split(model, og.conservative(
                    state.grid), held, tcfg, device=dev)
                torch.cuda.synchronize()
            launches = {"ray_march": kr.ray_march.launches,
                        "mlp_train_fwd": mt.mlp_train_fwd.launches,
                        "mlp_train_bwd": mt.mlp_train_bwd.launches,
                        "nerf_density": km.nerf_density.launches}
            losses = [r["loss"] for r in log.records]
            res[route] = (state.step / train_s, got["psnr"], launches,
                          calls.total, log.steady_steps_per_s(100))
            print(f"19c. 8 x {W} through the {route} on {card}: "
                  f"{state.step} steps in {train_s:.3f} s, "
                  f"{state.step / train_s:.2f} steps/s "
                  f"({res[route][4]:.2f} from step 100 on); loss "
                  f"{losses[0]:.5f} -> {losses[-1]:.5f}; held-out PSNR "
                  f"{got['psnr']:.3f} SSIM {got['ssim']:.4f} (untrained "
                  f"{base['psnr']:.3f}); launches {launches}; NeRF module "
                  f"calls {calls.total}; {rungs.summary()}")
            if not losses[-1] < losses[0] or \
                    got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
                fail(f"19c. 8 x {W} ({route}): did not train")
            n_cells = state.grid.n_cells
            del model, state
            release_memory()
        tol = WIDEST_PSNR_TOL_DB if W > 1024 else WIDE_PSNR_TOL_DB
        if kr.nerf_kernel_width(W) > 256 and abs(
                res["kernels"][1] - res["module"][1]) > tol:
            fail(f"19c. 8 x {W}: held-out PSNR {res['kernels'][1]:.3f} "
                 f"through the kernels, {res['module'][1]:.3f} through the "
                 f"module")
        k_launch, m_launch = res["kernels"][2], res["module"][2]
        want_density = refresh_launches(kcfg, n_cells, steps)
        if (k_launch["mlp_train_fwd"] != steps
                or k_launch["mlp_train_bwd"] != steps
                or k_launch["nerf_density"] != want_density
                or k_launch["ray_march"] == 0 or res["kernels"][3]):
            fail(f"19c. 8 x {W}: the kernels' route launched {k_launch} "
                 f"and called the module {res['kernels'][3]} times")
        if any(m_launch.values()) or not res["module"][3]:
            fail(f"19c. 8 x {W}: the module route launched {m_launch}")
        print(f"19c. 8 x {W} on {card}: kernels {res['kernels'][0]:.2f} "
              f"steps/s ({res['kernels'][4]:.2f} from step 100), PSNR "
              f"{res['kernels'][1]:.3f}; module {res['module'][0]:.2f} "
              f"steps/s ({res['module'][4]:.2f} from step 100), PSNR "
              f"{res['module'][1]:.3f}")



def siren_width_train_slices(cfg, dev, card):
    """Phase 19c for SiNeRF: the occgrid training slice (WIDTH_SIREN_TRAIN's
    graphed steps, the 8-view 128x128 sphere, then the held-out views) at
    8 x W for W in WIDTH_SIREN_TRAIN (512: the column-split SIREN kernels,
    1536: the streamed ones) through the kernels, launch counts set to 0
    before and read after (kernels 7 and 8 once per step, kernel 2 in the
    eval), the SiNeRF module called only for the grid refresh's densities;
    then the same run through the module (fused_kernel and fused_render
    off: the route a SiNeRF this wide took before the kernels took it):
    steps/s and held-out PSNR side by side, within WIDE_PSNR_TOL_DB (above
    1024 WIDEST_PSNR_TOL_DB, both routes' views rendered in chunks of a
    quarter of cli.EVAL_CHUNK's rays)."""
    import dataclasses

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    scene = SphereScene(n_imgs=8, hw=128, white_bkgd=True)
    held = cli.split_of(scene.holdout(n=3, seed=101))
    for W, n_steps in WIDTH_SIREN_TRAIN.items():
        kcfg = sinerf_config(train_slice_config(width_cfg(cfg, W)),
                             n_iters=n_steps)
        mcfg = kcfg.replace(model=dataclasses.replace(
            kcfg.model, fused_kernel=False, fused_render=False))
        untrained = make_model(kcfg, torch.bfloat16,
                               torch.Generator().manual_seed(0), dev)
        # above 1024 the held-out views in quarter chunks: the module's f32
        # sines of a whole chunk (16,384 rays x K 192 x 1536) take 18 GB
        chunk = cli.EVAL_CHUNK if W <= 1024 else cli.EVAL_CHUNK // 4
        base, _ = cli.evaluate_split(
            untrained, og.conservative(cli.rebuild_grid(
                untrained, kcfg, scene.aabb, dev)), held, kcfg, chunk,
            device=dev)
        res = {}
        for route, tcfg in (("kernels", kcfg), ("module", mcfg)):
            kr.siren_ray_march.launches = 0
            ks.siren_mlp_fwd.launches = ks.siren_mlp_bwd.launches = 0
            with ModuleCalls() as calls:
                model, state, log, _, train_s, rungs, _ = run_train_slice(
                    tcfg, dev)
                got, _ = cli.evaluate_split(model, og.conservative(
                    state.grid), held, tcfg, chunk, device=dev)
                torch.cuda.synchronize()
            counts = {"siren_mlp_fwd": ks.siren_mlp_fwd.launches,
                      "siren_mlp_bwd": ks.siren_mlp_bwd.launches,
                      "siren_ray_march": kr.siren_ray_march.launches}
            losses = [r["loss"] for r in log.records]
            steady = log.steady_steps_per_s()
            res[route] = (state.step / train_s, got["psnr"], counts,
                          calls.calls, state.step, steady)
            print(f"19c. SiNeRF 8 x {W} through the {route} on {card}: "
                  f"{state.step} steps in {train_s:.3f} s, "
                  f"{state.step / train_s:.2f} steps/s ({steady:.2f} from "
                  f"step 100 on); loss "
                  f"{losses[0]:.5f} -> {losses[-1]:.5f}; held-out PSNR "
                  f"{got['psnr']:.3f} SSIM {got['ssim']:.4f} (untrained "
                  f"{base['psnr']:.3f}); launches {counts}; SiNeRF module "
                  f"calls {calls.calls} on the MLP, {calls.density_calls} "
                  f"for the grid refresh; {rungs.summary()}")
            if not losses[-1] < losses[0] or \
                    got["psnr"] < base["psnr"] + MIN_PSNR_GAIN_DB:
                fail(f"19c. SiNeRF 8 x {W} ({route}): did not train")
            del model, state
            release_memory()
        k_launch, m_launch = res["kernels"][2], res["module"][2]
        steps = res["kernels"][4]
        if (k_launch["siren_mlp_fwd"] != steps
                or k_launch["siren_mlp_bwd"] != steps
                or k_launch["siren_ray_march"] == 0 or res["kernels"][3]):
            fail(f"19c. SiNeRF 8 x {W}: the kernels' route launched "
                 f"{k_launch} over {steps} steps and called the module "
                 f"{res['kernels'][3]} times on the MLP")
        if any(m_launch.values()) or not res["module"][3]:
            fail(f"19c. SiNeRF 8 x {W}: the module route launched "
                 f"{m_launch}")
        tol = WIDEST_PSNR_TOL_DB if W > 1024 else WIDE_PSNR_TOL_DB
        if abs(res["kernels"][1] - res["module"][1]) > tol:
            fail(f"19c. SiNeRF 8 x {W}: held-out PSNR "
                 f"{res['kernels'][1]:.3f} through the kernels, "
                 f"{res['module'][1]:.3f} through the module")
        print(f"19c. SiNeRF 8 x {W} on {card}: kernels "
              f"{res['kernels'][0]:.2f} steps/s ({res['kernels'][5]:.2f} "
              f"from step 100 on), PSNR {res['kernels'][1]:.3f}; module "
              f"{res['module'][0]:.2f} steps/s ({res['module'][5]:.2f}), "
              f"PSNR {res['module'][1]:.3f}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.synthetic import (SphereScene,
                                                 render_sphere_image)
    from fsnerf_tpu_torch.eval.metrics import psnr, ssim
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import build
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.render.renderer import render_path

    # -- 2. build -------------------------------------------------------
    built = build.build()
    build.load_library()
    print(f"build: {built.seconds:.1f} s -> {built.path.name}")
    for line in built.log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem")):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda")
    cfg = Config()
    siren_routes(cfg, dev, card)
    wide_launches, siren_wide_launches = width_routes(cfg, dev, card)

    # -- 3. kernel vs plain at full width ---------------------------------
    s = cfg.sampling
    model = make_model(cfg, torch.bfloat16, torch.Generator().manual_seed(0),
                       dev)
    split = cli.build_split("sphere", 1, 128, True, seed=1)
    grid = cli.rebuild_grid(model, cfg, split.aabb, dev)
    padded, bR, cs, eval_k = march_inputs(cfg, grid, split, dev)
    sd = model.state_dict()
    arch = dict(n_layers=cfg.model.n_layers, skip=cfg.model.skip,
                n_freqs=cfg.encoder.n_freqs,
                n_freqs_views=cfg.encoder.n_freqs_views, device=dev)
    march_params = kr.prep_params(sd, **arch)
    normal = compare("normal", kr.ray_march, kr.ray_march_reference, padded,
                     march_params, bR, cs, s.early_stop_eps)
    # the rows of the block x chunk steps this input needs, through the MLP
    march_bound = bound(
        2.0 * mlp_macs(cfg) * normal["executed"] * bR * cs,
        nbytes(*padded, march_params.wpack, march_params.bpack,
               march_params.enc) + padded[0].shape[0] * (8 + 1 / bR) * 4)
    hot_sd = dict(sd, **{"sigma.bias": sd["sigma.bias"]
                         + SATURATING_SIGMA_BIAS})
    hot = compare("early-exit", kr.ray_march, kr.ray_march_reference,
                  padded, kr.prep_params(hot_sd, **arch), bR, cs,
                  s.early_stop_eps)
    if hot["executed"] >= normal["executed"]:
        fail("a saturating sigma bias did not make blocks exit early")
    n_rays = split.hwf[0] * split.hwf[1]
    march_host_ms = host_ms_per_call(
        lambda: kr.ray_march(*padded, march_params, bR, cs,
                             s.early_stop_eps), 20)
    print(f"ray march at {n_rays} rays x K {eval_k} on {card}: kernel "
          f"{n_rays / normal['ms'] * 1e3:.0f} rays/s, plain "
          f"{n_rays / normal['plain_ms'] * 1e3:.0f} rays/s; early exit "
          f"{hot['ms']:.3f} ms; host {march_host_ms:.4f} ms per call; "
          f"bound share {march_bound['bound_ms'] / normal['ms']:.3f}")
    print(ptxas_of(built.log, "nerf_march_kernel"))

    # -- 4. the slice -----------------------------------------------------
    scene = SphereScene(n_imgs=1, hw=128)
    path = scene.path_poses[:3]
    path_split = cli.Split(
        np.stack([render_sphere_image(p, scene.hwf)[0] for p in path]), path,
        scene.hwf, scene.near, scene.far, False, scene.aabb, True)
    q_stride = og.grid_query_stride(s, scene.aabb, grid)
    kr.ray_march.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused = cli.make_fused_render_fn(sd, cfg, device=dev)
    path_k = cli.derive_eval_n_compact(grid, path_split, cfg, dev)
    frames, _ = render_path(
        lambda xx, dd=None: model(xx, dd), path, scene.hwf, scene.near,
        scene.far, device=dev, grid=grid, n_samples=s.n_samples,
        render_step_size=s.render_step_size, white_bkgd=True,
        n_compact=path_k, early_stop_eps=s.early_stop_eps,
        query_stride=q_stride, fused_render_fn=fused)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kr.ray_march.launches
    if launches == 0:
        fail("the render path never launched the ray-march kernel")
    if frames.shape != (3, 128, 128, 3) or not np.isfinite(frames).all():
        fail(f"bad frames: shape {frames.shape}, finite "
             f"{np.isfinite(frames).all()}")
    pred = torch.as_tensor(frames)
    gt = torch.as_tensor(path_split.imgs)
    p = float(psnr(pred, gt))
    q = float(np.mean([float(ssim(pred[i], gt[i])) for i in range(3)]))
    rays = frames.shape[0] * 128 * 128
    print(f"slice: 3 frames 128x128, K {path_k}, {launches} kernel "
          f"launches, {seconds:.3f} s, {rays / seconds:.0f} rays/s end to "
          f"end on {card} (first call, grid queries and sort included); "
          f"PSNR {p:.3f} SSIM {q:.4f} vs ground truth (random weights)")

    # -- 5. train kernels vs plain at full width ---------------------------
    fwd, bwd = train_kernels(cfg, dev, card)

    # -- 6. the training slice (CUDA graphs), 6b. against the eager loop ----
    train_launches, graphed = train_slice(cfg, dev, card)
    graphed_vs_eager(cfg, dev, card, graphed)
    del graphed

    # -- 7. forward MLP kernel vs plain at full width -----------------------
    mlp, mlp_module_ms = mlp_kernel(cfg, dev, card, built.log)

    # -- 8. the hierarchical render slice -----------------------------------
    hier_render_slice(model, cfg, dev, card)

    # -- 9. the hierarchical training slice ---------------------------------
    hier_launches = hier_train_slice(cfg, dev, card)

    # -- 10.-13. SiNeRF: the SIREN kernels and their slices ------------------
    siren_fwd, siren_bwd, siren_module_ms = siren_kernels(cfg, dev, card,
                                                          built.log)
    siren_rm, siren_march_module_ms = siren_march(cfg, dev, card,
                                                  built.log)
    siren_launches = siren_train_slice(cfg, dev, card)
    siren_hier_render_slice(cfg, dev, card)

    # -- 14.-16. the few-shot path: the density and compositing kernels ----
    density, density_module_ms, _ = density_kernel(cfg, dev, card,
                                                   built.log)
    volrend = volrend_kernel(cfg, dev, card)
    fewshot_launches = fewshot_slice(cfg, dev, card)

    # -- 19. the kernels at every width up to W_max ------------------------
    nerf_wide, siren_wide = width_kernels(cfg, dev, card, built.log,
                                          (padded, bR, cs))
    width_train_slices(cfg, dev, card)
    siren_width_train_slices(cfg, dev, card)

    with tempfile.TemporaryDirectory() as root:
        # -- 17.-18. the data slices: Blender and LLFF through the CLI ------
        with short_paths():
            _, _, blender = blender_slice(card, root)
            _, llff_png_psnr = llff_slice(dev, card, root)

        # -- 20. the data-parallel layer and LPIPS --------------------------
        gloo_two_ranks(cfg, dev, card)
        nccl_one_rank(cfg, dev, card)
        lpips_card(card)

        # -- 21. the serving artifact ---------------------------------------
        export_launches = serving_artifact(model, grid, cfg, dev, card,
                                           blender)

        # -- 22. JPEG: the fixtures, the LLFF flow, the decode rate ---------
        jpeg_phase(card, root, llff_png_psnr)

    # -- 23. report ---------------------------------------------------------
    for family, numbers, counts, widths in (
            ("NeRF", nerf_wide, wide_launches, NERF_REPORT_WIDTHS),
            ("SiNeRF", siren_wide, siren_wide_launches, SIREN_REPORT_WIDTHS)):
        if set(numbers) != set(widths) or not set(widths) <= set(counts):
            fail(f"the report's {family} widths {widths}: numbers at "
                 f"{sorted(numbers)}, launch counts at {sorted(counts)}")
    module_ms = dict(module_routes(cfg, dev, padded), nerf_mlp=mlp_module_ms,
                     siren_ray_march=siren_march_module_ms,
                     **siren_module_ms, nerf_density=density_module_ms)
    print(f"nearest cuBLAS route, the bf16 NeRF or SiNeRF module on each "
          f"kernel's rows on {card} (no single PyTorch call computes these "
          f"functions): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in module_ms.items()))
    print(json.dumps({"kernels": [{
        "name": "ray_march",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/render.cu",
        "replaces": "fsnerf_tpu/ops/pallas/render.py:189",
        "launches": launches,
        "max_abs_err": max(normal["max_abs_err"], hot["max_abs_err"]),
        "ms": normal["ms"],
        "plain_ms": normal["plain_ms"],
        **march_bound,
        "library_ms": None,
    }, {
        "name": "mlp_train_fwd",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/mlp_train.cu",
        "replaces": "fsnerf_tpu/ops/pallas/mlp_train.py:560",
        "launches": train_launches["mlp_train_fwd"],
        **fwd,
        "library_ms": None,
    }, {
        "name": "mlp_train_bwd",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/mlp_train.cu",
        "replaces": "fsnerf_tpu/ops/pallas/mlp_train.py:595",
        "launches": train_launches["mlp_train_bwd"],
        **bwd,
        "library_ms": None,
    }, {
        "name": "nerf_mlp",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/mlp.cu",
        "replaces": "fsnerf_tpu/ops/pallas/mlp.py:276",
        # the hierarchical eval's coarse passes, the few-shot validations
        # and the serving artifact's replays
        "launches": hier_launches["nerf_mlp"] + fewshot_launches["nerf_mlp"]
        + export_launches["nerf_mlp"],
        **mlp,
        "library_ms": None,
    }, {
        "name": "siren_ray_march",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/render.cu",
        "replaces": "fsnerf_tpu/ops/pallas/render.py:238",
        "launches": siren_launches["siren_ray_march"],
        **siren_rm,
        "library_ms": None,
    }, {
        "name": "siren_mlp_fwd",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/siren.cu",
        "replaces": "fsnerf_tpu/ops/pallas/siren.py:325",
        # the SiNeRF slice and the serving artifact's replays
        "launches": siren_launches["siren_mlp_fwd"]
        + export_launches["siren_mlp_fwd"],
        **siren_fwd,
        "library_ms": None,
    }, {
        "name": "siren_mlp_bwd",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/siren.cu",
        "replaces": "fsnerf_tpu/ops/pallas/siren.py:355",
        "launches": siren_launches["siren_mlp_bwd"],
        **siren_bwd,
        "library_ms": None,
    }, {
        "name": "nerf_density",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/mlp.cu",
        "replaces": "fsnerf_tpu/ops/pallas/mlp.py:428",
        "launches": fewshot_launches["nerf_density"],
        **density,
        "library_ms": None,
    }, {
        "name": "volrend",
        "route": "cuda",
        "source": "fsnerf_tpu_torch/csrc/volrend.cu",
        "replaces": "fsnerf_tpu/ops/pallas/volrend.py:91",
        "launches": fewshot_launches["volrend"],
        **volrend,
        "library_ms": None,
    }] + [{
        # the column-split instances at 512 and the streamed ones at 1024
        # (phase 19b's numbers; launches from phase 2b's SiNeRF 8 x 512 /
        # 8 x 1024 run: 20 train steps, the held-out view)
        "name": f"{name}@{K}",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": siren_wide_launches[K][name],
        "max_abs_err": siren_wide[K][name][3],
        "ms": siren_wide[K][name][0],
        "plain_ms": siren_wide[K][name][1],
        **siren_wide[K][name][2],
        "library_ms": None,
    } for K in sorted(siren_wide) for name, source, replaces in (
        ("siren_ray_march", "fsnerf_tpu_torch/csrc/render.cu",
         "fsnerf_tpu/ops/pallas/render.py:238"),
        ("siren_mlp_fwd", "fsnerf_tpu_torch/csrc/siren.cu",
         "fsnerf_tpu/ops/pallas/siren.py:325"),
        ("siren_mlp_bwd", "fsnerf_tpu_torch/csrc/siren.cu",
         "fsnerf_tpu/ops/pallas/siren.py:355"))] + [{
        # the NeRF kernels at the packed widths 512 (column-split), 768,
        # 1024 and 2048 (streamed): phase 19a's numbers (NeRF 512, 700,
        # 1024, 2048); launches from phase 2b's run at that width (20 train
        # steps, the held-out view's occgrid and hierarchical evals)
        "name": f"{name}@{K}",
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": wide_launches[K][name],
        "max_abs_err": nerf_wide[K][name][3],
        "ms": nerf_wide[K][name][0],
        "plain_ms": nerf_wide[K][name][1],
        **nerf_wide[K][name][2],
        "library_ms": None,
    } for K in sorted(nerf_wide) for name, source, replaces in (
        ("ray_march", "fsnerf_tpu_torch/csrc/render.cu",
         "fsnerf_tpu/ops/pallas/render.py:189"),
        ("nerf_mlp", "fsnerf_tpu_torch/csrc/mlp.cu",
         "fsnerf_tpu/ops/pallas/mlp.py:276"),
        ("nerf_density", "fsnerf_tpu_torch/csrc/mlp.cu",
         "fsnerf_tpu/ops/pallas/mlp.py:428"),
        ("mlp_train_fwd", "fsnerf_tpu_torch/csrc/mlp_train.cu",
         "fsnerf_tpu/ops/pallas/mlp_train.py:560"),
        ("mlp_train_bwd", "fsnerf_tpu_torch/csrc/mlp_train.cu",
         "fsnerf_tpu/ops/pallas/mlp_train.py:595"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
