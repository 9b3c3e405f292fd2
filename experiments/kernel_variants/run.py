#!/usr/bin/env python3
"""Time the kernel variants that were tried while the Schur and remap
kernels were redesigned, on one CUDA card, from the repository root:

    python3 experiments/kernel_variants/run.py

Builds the three sources beside this file with nvcc into
``build/kernel_variants/`` and prints, for each variant, whether it agrees
with the plain PyTorch version and its device time per call (a CUDA graph
of 20 calls replayed, and single calls after the L2 was overwritten), next
to the package's own kernel and the library call: the remap variants on a
1080x1920 frame (float32, and uint8 RGB) and on 12 stacked float32 frames
through the reference-coefficient distortion map; the Schur products with
the two-kernel and the ticket reduction at several numbers of slabs.
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
from photogrammetry_tpu_torch.kernels import _build, remap, schur  # noqa: E402
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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    schur_variants(dev)
    remap_variants(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
