#!/usr/bin/env python3
"""Time the kernel variants that were tried while the kernels were
redesigned, on one CUDA card, from the repository root:

    python3 experiments/kernel_variants/run.py [schur] [remap] [hamming] \
        [fast] [hamming_p] [brief]

(all groups without arguments).  Builds the sources beside this file
with nvcc into ``build/kernel_variants/`` and prints, for each variant,
whether it agrees with the plain PyTorch version and its device time per
call (a CUDA graph of 20 calls replayed, and for remap single calls after
the L2 was overwritten), next to the package's own kernel and the library
call:

- remap: on a 1080x1920 frame (float32, and uint8 RGB) and on 12 stacked
  float32 frames through the reference-coefficient distortion map;
- schur: the two-kernel and the ticket reduction at several numbers of
  slabs;
- hamming: at the forward path's 2048 x 2048 and the SfM path's 512 x 512
  (256 bits), the package's tensor-core kernel at every tile it compiles,
  the earlier popcount kernel (``hamming_popcount.cu``) on packed words
  alone and with its two ``pack_bits`` calls, and the in-kernel ballot packing
  with a register-blocked popcount (``hamming_ballot.cu``);
- hamming also: where the 128 x 128 tile's time goes (phases left out),
  staging by the TMA, an epilogue through shared memory, a persistent
  form that stages the next tile while it stores this one, and tiles with
  more warps (``hamming_probe.cu``);
- fast: one rendered 1080p frame of the pan, the 12-frame batch, a noise
  frame and a flat one, the earlier kernel (``fast_stencil_recurrence.cu``)
  and the package's kernel with and without the compass pre-test, at 4 or 1
  pixels a thread, at 64, 32 or 16 rows a tile and with its scalar
  staging (``fast_variants.cu``), and a persistent, cp.async-pipelined
  form (``fast_probe.cu``).
- hamming_p: the package's kernel (512 columns a pass, any P) beside its
  single-pass form from before the K loop (``hamming_single_pass.cu``) at
  P = 256, 2048 x 2048 and 512 x 512, in turns; then at P = 48, 96, 544
  and 1024;
- brief: at the forward path's 2048 keypoints x 256 pairs on a rendered
  frame and the SfM path's 12 frames x 512 keypoints (``SfmConfig``'s
  frontend), the package's kernel and its gather probe at 8, 16 and 32
  keypoints a block, in the caller's (score) order and with the keypoints
  sorted by 64-px cell beforehand; from ``brief_variants.cu`` its samples
  through a texture object, an in-kernel spatial order at 8 to 64
  keypoints a block (with its probe) and a lane per keypoint; steered; and
  the earlier kernel (``brief_per_bit.cu``), a launch and a mask multiply
  a frame.

The variant tables in the sources name the template arguments of each id.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

import torch                                    # noqa: E402
import torch.nn.functional as F                 # noqa: E402

import chip_smoke as cs                         # noqa: E402
from photogrammetry_tpu_torch.kernels import (  # noqa: E402
    _build, brief_pack, fast_stencil, hamming, remap, schur,
)
from photogrammetry_tpu_torch.ops.brief import pack_bits  # noqa: E402
from photogrammetry_tpu_torch.ops.dewarp import generate_distortion_map  # noqa: E402


def build(name: str) -> ctypes.CDLL:
    out = ROOT / "build" / "kernel_variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{name}.so"
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(HERE / f"{name}.cu")], capture_output=True,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(run.stdout + run.stderr)
    return ctypes.CDLL(str(lib))


def report(label, run, out, ref, dev):
    out.zero_()
    run()
    torch.cuda.synchronize()
    print(label, "exact", bool(torch.equal(out, ref)), "graph_ms",
          round(cs.graph_ms(run), 5), "cold_ms", round(cs.cold_ms(run, dev), 5),
          flush=True)


def remap_variants(dev):
    h, w = cs.FRAME_SHAPE
    dmap = generate_distortion_map(h, w, cs.DEWARP_COEFFS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    grid = torch.stack([dmap[..., 1] * (2.0 / (w - 1)) - 1.0,
                        dmap[..., 0] * (2.0 / (h - 1)) - 1.0], -1)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])
    cases = (("remap_f32_variants", torch.float32, 1, (1, 12), 19),
             ("remap_u8_variants", torch.uint8, 3, (1,), 20))
    for name, dtype, ch, batches, count in cases:
        fn = build(name).exp_launch
        fn.argtypes = argtypes
        stack = torch.randint(0, 256, (max(batches), h, w, ch), generator=gen,
                              device=dev).to(dtype)
        for b in batches:
            imgs = stack[:b].contiguous()
            ref = remap.remap_bilinear_plain(imgs, dmap)
            out = torch.empty_like(ref)
            nchw = imgs.permute(0, 3, 1, 2).float().contiguous()
            grids = grid[None].expand(b, h, w, 2).contiguous()
            print(name, "B", b, "grid_sample graph_ms", cs.graph_ms(
                lambda: F.grid_sample(nchw, grids, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)),
                  "package kernel graph_ms",
                  cs.graph_ms(lambda: remap.remap_bilinear(imgs, dmap)),
                  flush=True)
            for v in range(count):
                def run(v=v):
                    err = fn(v, imgs.data_ptr(), dmap.data_ptr(),
                             out.data_ptr(), b, h, w, h, w, stream())
                    _build.check(err, f"{name} variant {v}")
                report(f"{name} B {b} variant {v}", run, out, ref, dev)


def schur_variants(dev):
    fn = build("schur_ticket").schur_ticket_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    for f, t in cs.SCHUR_SHAPES[:2]:
        args = cs.schur_inputs(dev, f, t, seed=f * t)
        ref = schur.schur_products(*args)
        tiles = -(-f // schur.CAM_TILE)
        tickets = torch.zeros(tiles * tiles, dtype=torch.int32, device=dev)
        s_off, corr = (torch.empty_like(x) for x in ref)
        for slabs in (8, 16, 32, 64):
            plan = schur.split_plan(f, t, slabs)
            part = torch.empty(plan.scratch_shape, device=dev)
            for label, tk in (("two_kernels", None), ("ticket", tickets)):
                def run(tk=tk):
                    err = fn(*(x.data_ptr() for x in args), f, t, plan.slabs,
                             plan.slab_len, part.data_ptr(),
                             None if tk is None else tk.data_ptr(),
                             s_off.data_ptr(), corr.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
                    _build.check(err, "schur_ticket_launch")
                run()
                torch.cuda.synchronize()
                same = (torch.equal(s_off, schur.schur_products(
                    *args, slabs=slabs)[0]))
                print(f"schur F{f} T{t} slabs {plan.slabs} {label}",
                      "equal_to_package_kernel", same, "graph_ms",
                      round(cs.graph_ms(run), 5), flush=True)


def hamming_variants(dev):
    old = build("hamming_popcount").hamming_launch
    old.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
    ballot = build("hamming_ballot").hamming_ballot_launch
    ballot.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4)
    probe = build("hamming_probe").probe_launch
    probe.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 4)
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(3)
    p = 256
    for n in (2048, 512):
        b1, b2 = (torch.randint(0, 2, (n, p), generator=gen, device=dev)
                  .to(torch.uint8) for _ in range(2))
        m1, m2 = (torch.rand(n, generator=gen, device=dev) > 0.1
                  for _ in range(2))
        ref = hamming.hamming_distance_matrix_plain(b1, b2, m1, m2)
        out = torch.empty_like(ref)
        tag = f"hamming {n}x{n}"
        print(tag, "plan", tuple(hamming.tile_plan(n, n)), "package graph_ms",
              cs.graph_ms(lambda: hamming.hamming_distance_matrix(b1, b2, m1,
                                                                  m2)),
              flush=True)
        for tile in hamming.TILES:
            plan = hamming.TilePlan(*tile, -(-n // tile[1]), -(-n // tile[0]))
            report(f"{tag} mma tile {tile}", lambda plan=plan: hamming.launch(
                b1, b2, m1.data_ptr(), m2.data_ptr(), out, plan),
                out, ref, dev)
        w1, w2 = pack_bits(b1).contiguous(), pack_bits(b2).contiguous()

        def popcount(w1=w1, w2=w2):
            _build.check(old(w1.data_ptr(), n, w2.data_ptr(), n, p // 32,
                             m1.data_ptr(), m2.data_ptr(), out.data_ptr(),
                             stream()), "hamming_popcount")

        def packed_and_popcount():
            popcount(pack_bits(b1).contiguous(), pack_bits(b2).contiguous())

        report(f"{tag} earlier popcount kernel alone", popcount, out, ref, dev)
        report(f"{tag} earlier popcount kernel with pack_bits",
               packed_and_popcount, out, ref, dev)
        report(f"{tag} ballot packing + popcount", lambda: _build.check(
            ballot(b1.data_ptr(), n, b2.data_ptr(), n, p, m1.data_ptr(),
                   m2.data_ptr(), out.data_ptr(), stream()), "ballot"),
            out, ref, dev)
        if n != 2048:
            continue
        # where the 128 x 128 tile's time goes, and the persistent form
        zeros = torch.zeros_like(out)
        print(f"{tag} fill_ of the output graph_ms",
              cs.graph_ms(lambda: zeros.fill_(0)), flush=True)
        for v, name in enumerate(("probe all", "probe no products",
                                  "probe no stores", "probe no staging",
                                  "probe stores only", "probe TMA staging",
                                  "probe shared-memory epilogue",
                                  "probe TMA staging + shared-memory "
                                  "epilogue",
                                  "mma tile (128, 128, 32, 32)",
                                  "mma tile (256, 128, 64, 32)",
                                  "mma tile (256, 128, 32, 32)",
                                  "mma tile (128, 256, 32, 64)",
                                  "persistent 1/block",
                                  "persistent 2/block",
                                  "persistent 3/block")):
            report(f"{tag} {name}", lambda v=v: _build.check(probe(
                v, b1.data_ptr(), n, b2.data_ptr(), n, p, m1.data_ptr(),
                m2.data_ptr(), out.data_ptr(), stream()), "probe"),
                out, ref, dev)


def fast_variants(dev):
    old = build("fast_stencil_recurrence").fast_score_launch
    old.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                    + [ctypes.c_float, ctypes.c_void_p])
    new = build("fast_variants").exp_launch
    new.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    probe = build("fast_probe").probe_launch
    probe.argtypes = new.argtypes
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    seq = torch.as_tensor(cs.render_sequence()[0], device=dev).float()
    h, w = seq.shape[1:]
    gen = torch.Generator(device=dev).manual_seed(4)
    noise = torch.randint(0, 256, (1, h, w), generator=gen,
                          device=dev).float()
    thr = 50.0   # chip_smoke.py's frontend threshold
    cases = (("frame", seq[:1].contiguous()), ("batch12", seq),
             ("noise", noise), ("flat", torch.full((1, h, w), 9.0,
                                                   device=dev)))
    for label, imgs in cases:
        b = imgs.shape[0]
        ref = fast_stencil.fast_score_map_plain(imgs, thr)
        out = torch.empty_like(ref)
        print(f"fast {label}", list(imgs.shape), "corners",
              int((ref > 0).sum()), flush=True)
        report(f"fast {label} earlier recurrence kernel",
               lambda imgs=imgs: _build.check(
                   old(imgs.data_ptr(), out.data_ptr(), b, h, w, thr,
                       stream()), "fast_recurrence"), out, ref, dev)
        for v, name in enumerate(("4px compass 64 rows (package)",
                                  "4px no compass", "1px compass",
                                  "1px no compass", "4px compass 32 rows",
                                  "4px compass 16 rows",
                                  "package with scalar staging")):
            report(f"fast {label} {name}", lambda imgs=imgs, v=v:
                   _build.check(new(v, imgs.data_ptr(), out.data_ptr(), b, h,
                                    w, thr, stream()), "fast_variants"),
                   out, ref, dev)
        for v, name in enumerate(("probe pipelined 132 blocks",
                                  "probe pipelined 264 blocks",
                                  "probe pipelined 528 blocks",
                                  "probe pipelined 1056 blocks")):
            report(f"fast {label} {name}", lambda imgs=imgs, v=v:
                   _build.check(probe(v, imgs.data_ptr(), out.data_ptr(), b,
                                      h, w, thr, stream()), "fast_probe"),
                   out, ref, dev)


def hamming_p_variants(dev):
    single = build("hamming_single_pass").hamming_launch
    single.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    gen = torch.Generator(device=dev).manual_seed(5)
    for n, p in ((2048, 256), (512, 256), (2048, 48), (2048, 96),
                 (2048, 544), (2048, 1024), (512, 1024)):
        b1, b2 = (torch.randint(0, 2, (n, p), generator=gen, device=dev)
                  .to(torch.uint8) for _ in range(2))
        m1, m2 = (torch.rand(n, generator=gen, device=dev) > 0.1
                  for _ in range(2))
        ref = hamming.hamming_distance_matrix_plain(b1, b2, m1, m2)
        out = torch.empty_like(ref)
        plan = hamming.tile_plan(n, n)
        tag = f"hamming_p {n}x{n} P {p} tile {tuple(plan[:4])}"

        def package():
            hamming.launch(b1, b2, m1.data_ptr(), m2.data_ptr(), out, plan)

        def single_pass():
            _build.check(single(b1.data_ptr(), n, b2.data_ptr(), n, p,
                                m1.data_ptr(), m2.data_ptr(), out.data_ptr(),
                                *plan[:4],
                                torch.cuda.current_stream(dev).cuda_stream),
                         "hamming_single_pass")

        turns = ((("single pass", single_pass), ("package", package),
                  ("package", package), ("single pass", single_pass))
                 if p == 256 else (("package", package),))
        for label, run in turns:
            report(f"{tag} {label}", run, out, ref, dev)


def _cell_order(coords, h, w):
    """Per frame, the permutation that sorts (B, N, 2) keypoints by 64-px
    cell, row-major over the cells."""
    cells = ((coords[..., 0].clamp(0, h - 1) // 64) * ((w + 63) // 64)
             + coords[..., 1].clamp(0, w - 1) // 64)
    return torch.argsort(cells, dim=1, stable=True)


def brief_variants(dev):
    from photogrammetry_tpu_torch.ops.brief import angles_cos_sin
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, _detect_from_score, make_pairs,
    )
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig
    from photogrammetry_tpu_torch.utils.padding import PaddedPoints

    lib = build("brief_variants")
    exp = lib.exp_launch
    exp.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                    + [ctypes.c_int, ctypes.c_void_p]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
    lib.exp_tex_create.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.exp_tex_create.restype = ctypes.c_ulonglong
    lib.exp_tex_destroy.argtypes = [ctypes.c_ulonglong]
    old = build("brief_per_bit").brief_bits_launch
    old.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731

    seq = torch.as_tensor(cs.render_sequence()[0], device=dev).float()
    h, w = seq.shape[1:]
    fwd = FrontendConfig(detection_threshold=50.0,
                         max_keypoints=cs.MAX_KEYPOINTS, reduction="nms",
                         suppression_radius=4.0)
    sfm = SfmConfig().frontend

    def detect(frames, cfg):
        scores = fast_stencil.fast_score_map_batch(frames,
                                                   cfg.detection_threshold)
        pts = [_detect_from_score(s, cfg) for s in scores]
        return PaddedPoints(*(torch.stack(x) for x in zip(*pts)))

    cases = (("2048x256", seq[:1].contiguous(), fwd),
             ("b12x512", seq, sfm))
    for label, frames, cfg in cases:
        pairs = make_pairs(cfg, device=dev)
        pts = detect(frames, cfg)
        b, n = pts.coords.shape[:2]
        p = pairs.shape[0]
        print(f"brief {label}", list(frames.shape), "keypoints",
              pts.count.tolist(), "pairs", p, flush=True)
        out = torch.empty((b, n, p), dtype=torch.uint8, device=dev)
        order = _cell_order(pts.coords, h, w)
        sorted_in = [torch.gather(x, 1, order[..., None].expand_as(x))
                     .contiguous() if x.dim() == 3 else
                     torch.gather(x, 1, order).contiguous()
                     for x in (pts.coords, pts.mask)]
        tex = lib.exp_tex_create(frames.data_ptr(), frames.numel())
        for order_label, (coords, mask) in (
                ("score order", (pts.coords, pts.mask)),
                ("sorted by cell beforehand", sorted_in)):
            ref = brief_pack.brief_bits_plain(frames, coords, pairs, mask)
            probe = torch.empty(b * brief_pack.blocks_per_frame(n) * 256,
                                dtype=torch.int32, device=dev)
            for kpb, spatial in ((8, 0), (16, 0), (32, 0), (8, 1), (16, 1),
                                 (32, 1), (64, 1)):
                # the package's kernel and probe (8 keypoints a block) in
                # the caller's order; the copy in brief_variants.cu for the
                # other runs a block, the texture fetch and the in-kernel
                # spatial order
                package = kpb == brief_pack.KEYPOINTS_PER_BLOCK and not spatial
                for v, name in ((0, "package kernel"), (1, "texture fetch"),
                                (3, "gather probe")):
                    if v == 1 and spatial:
                        continue
                    tag = (f"brief {label} {order_label} kpb {kpb} "
                           f"{'in-kernel spatial ' if spatial else ''}{name}")

                    def run(v=v, kpb=kpb, spatial=spatial, package=package,
                            tag=tag, coords=coords, mask=mask):
                        if package and v in (0, 3):
                            brief_pack.launch(frames, coords, pairs, mask,
                                              None, out,
                                              probe if v == 3 else None)
                            return
                        _build.check(exp(
                            v, frames.data_ptr(), tex, b, h, w,
                            coords.data_ptr(), mask.data_ptr(), n,
                            pairs.data_ptr(), p, kpb, spatial, out.data_ptr(),
                            probe.data_ptr(), stream()), tag)
                    if v == 3:
                        run()
                        torch.cuda.synchronize()
                        print(tag, "graph_ms", round(cs.graph_ms(run), 5),
                              flush=True)
                    else:
                        report(tag, run, out, ref, dev)
            report(f"brief {label} {order_label} lane per keypoint",
                   lambda coords=coords, mask=mask: _build.check(exp(
                       2, frames.data_ptr(), tex, b, h, w, coords.data_ptr(),
                       mask.data_ptr(), n, pairs.data_ptr(), p, 32, 0,
                       out.data_ptr(), None, stream()), "lane per keypoint"),
                   out, ref, dev)
        lib.exp_tex_destroy(tex)
        # steered, at the package's plan
        cos_sin = angles_cos_sin(torch.rand((b, n), device=dev) * 6.2832)
        ref = brief_pack.brief_bits_plain(frames, pts.coords, pairs,
                                          pts.mask, cos_sin)
        report(f"brief {label} steered package kernel",
               lambda: brief_pack.launch(frames, pts.coords, pairs, pts.mask,
                                         cos_sin, out),
               out, ref, dev)
        # the earlier kernel alone, a launch a frame and no mask (its bits
        # for masked keypoints are not zero: checked against the unmasked
        # plain bits), in turns with the package kernel on the same inputs
        ref_all = brief_pack.brief_bits_plain(frames, pts.coords, pairs)
        ref = brief_pack.brief_bits_plain(frames, pts.coords, pairs, pts.mask)
        alone = torch.empty_like(out)

        def earlier_alone():
            for i in range(b):
                _build.check(old(frames[i].data_ptr(), h, w,
                                 pts.coords[i].data_ptr(), n,
                                 pairs.data_ptr(), p, alone[i].data_ptr(),
                                 stream()), "brief_per_bit")

        for name in ("earlier kernel alone", "package kernel",
                     "package kernel", "earlier kernel alone"):
            if name == "package kernel":
                report(f"brief {label} turns {name}",
                       lambda: brief_pack.launch(frames, pts.coords, pairs,
                                                 pts.mask, None, out),
                       out, ref, dev)
            else:
                report(f"brief {label} turns {name}", earlier_alone, alone,
                       ref_all, dev)

        # the earlier kernel, as the frontend ran it: a launch and a mask
        # multiply a frame, then the frames stacked
        def earlier():
            rows = []
            for i in range(b):
                bits = torch.empty((n, p), dtype=torch.uint8, device=dev)
                _build.check(old(frames[i].data_ptr(), h, w,
                                 pts.coords[i].data_ptr(), n,
                                 pairs.data_ptr(), p, bits.data_ptr(),
                                 stream()), "brief_per_bit")
                rows.append(bits * pts.mask[i, :, None].to(torch.uint8))
            out.copy_(torch.stack(rows))

        report(f"brief {label} earlier kernel + mask multiply a frame",
               earlier, out, ref, dev)
        print(f"brief {label} package brief_bits graph_ms",
              cs.graph_ms(lambda: brief_pack.brief_bits(
                  frames, pts.coords, pairs, pts.mask)),
              "call_ms", cs.cuda_ms(lambda: brief_pack.brief_bits(
                  frames, pts.coords, pairs, pts.mask)), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    groups = {"schur": schur_variants, "remap": remap_variants,
              "hamming": hamming_variants, "fast": fast_variants,
              "hamming_p": hamming_p_variants, "brief": brief_variants}
    for name in sys.argv[1:] or list(groups):
        groups[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
