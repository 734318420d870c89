"""Device times of the port's 3x3 conv kernels at the neu step's shapes, for
comparing two checkouts on one card.

    python3 uaps_tpu_torch/conv_times.py [ROOT]

imports `uaps_tpu_torch` from the checkout at ROOT (default: the one that
holds this file), builds its conv libraries and prints one JSON line: the
bf16 forward, dgrad and wgrad of `conv3x3_nchw` at each of the 9 kernel
convs of a neu batch (B = 16; no dgrad for the first, whose input is the
image) and their sums in ms; the wgrad summed over a fullh UAPS step's
launches (`wgrad_fullh_per_step`); and the backward of `chain_conv_plain`
(the moment fold, the dgrad and the wgrad, both moment cotangents on) at
the four chain block shapes of a neu UAPS step (no dgrad for in_conv,
whose input is the image), with its sum over a chain step's launches
(`chain_bwd_per_step`). Each time is the median over 5 rounds of CUDA
events around 20 back-to-back calls queued behind a ~2.5 ms spin, so that
the host's enqueue is not counted (chip_smoke.py `Smoke.time_ms`). Two
separate runs may land on two different cards: compare checkouts within one
run, in turns (A, B, B, A). Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

BATCH = 16
# (module, Cin, Cout, H = W) of the 9 kernel convs of a neu batch
CONV_SHAPES = [("in_conv.0", 3, 16, 256), ("in_conv.4", 16, 16, 256),
               ("down1.0", 16, 32, 128), ("down1.4", 32, 32, 128),
               ("up3.0", 64, 32, 128), ("up3.4", 32, 32, 128),
               ("up4.0", 32, 16, 256), ("up4.4", 16, 16, 256),
               ("out_conv", 16, 4, 256)]
# wgrad launches of a fullh UAPS step at those shapes (chip_smoke.py
# FULLH_SHAPES; the heads take the default entry)
FULLH_WGRADS = {"in_conv.0": 2, "in_conv.4": 10, "down1.0": 2, "down1.4": 10,
                "up3.0": 8, "up4.0": 8}
# (block, conv1's Cin, Cout, H = W, backwards a chain step) of the chain
# blocks (chip_smoke.py CHAIN_BLOCKS)
CHAIN_BLOCKS = [("in_conv", 3, 16, 256, 2), ("down1", 16, 32, 128, 2),
                ("up3", 64, 32, 128, 8), ("up4", 32, 16, 256, 8)]


def time_ms(torch, fn, iters=20, rounds=5, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)   # cycles, ~2.5 ms
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def main(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("conv_times: no CUDA card")
    from uaps_tpu_torch.kernels import _build
    from uaps_tpu_torch.kernels import block_conv as kbc
    from uaps_tpu_torch.kernels import conv3x3_nchw as kc
    if not kc.__file__.startswith(root):
        raise SystemExit(f"conv_times: imported {kc.__file__}, not {root}")
    _build.build(["conv3x3_nchw", "conv3x3_wgrad_nchw", "block_conv"])
    dev, bf = torch.device("cuda:0"), torch.bfloat16
    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "shapes": {}, "fwd": 0.0, "dgrad": 0.0, "wgrad": 0.0,
           "wgrad_fullh_per_step": 0.0, "chain_bwd": {},
           "chain_bwd_per_step": 0.0}
    for i, (mod, cin, cout, hw) in enumerate(CONV_SHAPES):
        g = torch.Generator(device=dev).manual_seed(1234 + i)
        x = torch.randn((BATCH, cin, hw, hw), generator=g, device=dev).to(bf)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
             / (9 * cin) ** 0.5).to(bf)
        gy = torch.randn((BATCH, cout, hw, hw), generator=g,
                         device=dev).to(bf)
        o = torch.float32 if mod == "out_conv" else bf
        row = {"fwd": time_ms(torch, lambda: kc.conv3x3_nchw(x, w, o)),
               "wgrad": time_ms(torch, lambda: kc.conv3x3_nchw_wgrad(x, gy))}
        if i > 0:
            row["dgrad"] = time_ms(torch,
                                   lambda: kc.conv3x3_nchw_dgrad(gy, w))
        out["shapes"][f"{mod} {cin}->{cout} @{hw}"] = row
        for k, v in row.items():
            out[k] += v
        out["wgrad_fullh_per_step"] += FULLH_WGRADS.get(mod, 0) * row["wgrad"]
    for i, (blk, cin, cout, hw, n) in enumerate(CHAIN_BLOCKS):
        g = torch.Generator(device=dev).manual_seed(1400 + i)
        x = torch.randn((BATCH, cin, hw, hw), generator=g, device=dev).to(bf)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
             / (9 * cin) ** 0.5).to(bf)
        gy = torch.randn((BATCH, cout, hw, hw), generator=g,
                         device=dev).to(bf)
        ds1 = torch.randn(cout, generator=g, device=dev) * 0.3
        ds2 = torch.randn(cout, generator=g, device=dev) * 0.1
        y = kbc.chain_conv_plain(x, w)[0]
        need_dx = blk != "in_conv"
        ms = time_ms(torch, lambda: kbc._backward(
            gy, ds1, ds2, y, x, None, None, w, None, 0.0, need_dx))
        out["chain_bwd"][f"{blk}.0 {cin}->{cout} @{hw}"] = ms
        out["chain_bwd_per_step"] += n * ms
    return out


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(main(os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                                          else here))), flush=True)
