"""Device times of the port's 3x3 conv kernels at the neu step's shapes, for
comparing two checkouts on one card.

    python3 uaps_tpu_torch/conv_times.py [ROOT]

imports `uaps_tpu_torch` from the checkout at ROOT (default: the one that
holds this file), builds its conv libraries and prints one JSON line of
bf16 times in ms:
  * the forward, dgrad and wgrad of `conv3x3_nchw` at each of the 9 kernel
    convs of a neu batch (B = 16; no dgrad for the first, whose input is
    the image) and their sums (`fwd`, `dgrad`, `wgrad`: a baseline step);
    the same kernels summed over a fullh UAPS step's launches
    (`fwd_fullh_per_step`, `dgrad_fullh_per_step`,
    `wgrad_fullh_per_step`);
  * at the four chain block shapes of a neu UAPS step: the forward of
    `chain_conv_plain` (the block's first conv) and of `chain_conv_bnl`
    (its second, at the level's dropout rate), and the backward of
    `chain_conv_plain` (the moment fold, the dgrad and the wgrad, both
    moment cotangents on; no dgrad for in_conv, whose input is the image),
    each with its sum over a chain step's launches (`chain_fwd_per_step`,
    `chain_bnl_fwd_per_step`, `chain_bwd_per_step`);
  * `conv3x3_bnl` at the fused step's two shapes, summed over its 16
    launches (`bnl_fwd_per_step`), and the stats conv
    (`conv3x3_nchw_stats`) at the bn_stats blocks' four convs, summed
    (`stats_fwd_per_run`).
Each time is the median over 5 rounds of CUDA events around 20
back-to-back calls queued behind a ~2.5 ms spin, so that the host's enqueue
is not counted (chip_smoke.py `Smoke.time_ms`). Two separate runs may land
on two different cards: compare checkouts within one run, in turns (A, B,
B, A). Needs a CUDA card.
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
# (forward, dgrad, wgrad) launches of a fullh UAPS step at those shapes
# (chip_smoke.py FULLH_SHAPES, where in_conv.4 stands for in_conv.4 + up4.4
# and down1.4 for down1.4 + up3.4; the heads take the default entry)
FULLH_LAUNCHES = {"in_conv.0": (2, 0, 2), "in_conv.4": (10, 10, 10),
                  "down1.0": (2, 2, 2), "down1.4": (10, 10, 10),
                  "up3.0": (8, 8, 8), "up4.0": (8, 8, 8)}
# (block, conv1's Cin, Cout, H = W, dropout rate, calls a chain step) of
# the chain blocks (chip_smoke.py CHAIN_BLOCKS); the fused step runs
# conv3x3_bnl at the dropout-free blocks' second conv as often
CHAIN_BLOCKS = [("in_conv", 3, 16, 256, 0.05, 2),
                ("down1", 16, 32, 128, 0.1, 2),
                ("up3", 64, 32, 128, 0.0, 8),
                ("up4", 32, 16, 256, 0.0, 8)]
# the bn_stats blocks' convs (chip_smoke.py STATS_SHAPES), once a run
STATS_SHAPES = [("in_conv.0", 3, 16, 256), ("down1.0", 16, 32, 128),
                ("in_conv.4", 16, 16, 256), ("down1.4", 32, 32, 128)]


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


def _case(torch, dev, seed, cin, cout, hw):
    """bf16 x [B, Cin, H, W], w [3, 3, Cin, Cout] (lecun_normal scale), a
    cotangent g [B, Cout, H, W], BN's f, s [Cin] f32, moment cotangents
    [Cout] f32 and a dropout seed."""
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((BATCH, cin, hw, hw), generator=g, device=dev).to(bf)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         / (9 * cin) ** 0.5).to(bf)
    gy = torch.randn((BATCH, cout, hw, hw), generator=g, device=dev).to(bf)
    f = torch.rand(cin, generator=g, device=dev) + 0.5
    s = torch.randn(cin, generator=g, device=dev) * 0.1
    ds1 = torch.randn(cout, generator=g, device=dev) * 0.3
    ds2 = torch.randn(cout, generator=g, device=dev) * 0.1
    sd = torch.randint(0, 2 ** 31 - 1, (), generator=g, device=dev)
    return x, w, gy, f, s, ds1, ds2, sd


def main(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("conv_times: no CUDA card")
    from uaps_tpu_torch.kernels import _build
    from uaps_tpu_torch.kernels import block_conv as kbc
    from uaps_tpu_torch.kernels import conv3x3_nchw as kc
    from uaps_tpu_torch.kernels import conv_bnl as kbnl
    if not kc.__file__.startswith(root):
        raise SystemExit(f"conv_times: imported {kc.__file__}, not {root}")
    _build.build(["conv3x3_nchw", "conv3x3_wgrad_nchw", "block_conv"])
    dev, bf = torch.device("cuda:0"), torch.bfloat16
    sums = ("fwd", "dgrad", "wgrad", "fwd_fullh_per_step",
            "dgrad_fullh_per_step", "wgrad_fullh_per_step",
            "chain_fwd_per_step", "chain_bnl_fwd_per_step",
            "chain_bwd_per_step", "bnl_fwd_per_step", "stats_fwd_per_run")
    out = {"root": root, "card": torch.cuda.get_device_name(0),
           "shapes": {}, "chain": {}, "stats": {}, **dict.fromkeys(sums, 0.0)}
    for i, (mod, cin, cout, hw) in enumerate(CONV_SHAPES):
        x, w, gy, *_ = _case(torch, dev, 1234 + i, cin, cout, hw)
        o = torch.float32 if mod == "out_conv" else bf
        row = {"fwd": time_ms(torch, lambda: kc.conv3x3_nchw(x, w, o)),
               "wgrad": time_ms(torch, lambda: kc.conv3x3_nchw_wgrad(x, gy))}
        if i > 0:
            row["dgrad"] = time_ms(torch,
                                   lambda: kc.conv3x3_nchw_dgrad(gy, w))
        out["shapes"][f"{mod} {cin}->{cout} @{hw}"] = row
        for k, v in row.items():
            out[k] += v
        for k, n in zip(("fwd", "dgrad", "wgrad"),
                        FULLH_LAUNCHES.get(mod, (0, 0, 0))):
            out[f"{k}_fullh_per_step"] += n * row.get(k, 0.0)
    for i, (blk, cin, cout, hw, rate, n) in enumerate(CHAIN_BLOCKS):
        x, w, gy, _, _, ds1, ds2, _ = _case(torch, dev, 1400 + i, cin, cout,
                                            hw)
        y = kbc.chain_conv_plain(x, w)[0]
        need_dx = blk != "in_conv"
        row = {"plain_fwd": time_ms(torch, lambda: kbc.chain_conv_plain(x, w)),
               "plain_bwd": time_ms(torch, lambda: kbc._backward(
                   gy, ds1, ds2, y, x, None, None, w, None, 0.0, need_dx))}
        # the second conv: Cout -> Cout on the first's raw output
        z, w2, _, f, s, _, _, sd = _case(torch, dev, 1420 + i, cout, cout, hw)
        row["bnl_fwd"] = time_ms(
            torch, lambda: kbc.chain_conv_bnl(z, f, s, w2, sd, rate))
        if rate == 0:
            row["conv3x3_bnl"] = time_ms(
                torch, lambda: kbnl.conv3x3_bnl(z, f, s, w2))
            out["bnl_fwd_per_step"] += n * row["conv3x3_bnl"]
        out["chain"][f"{blk} {cin}->{cout}->{cout} @{hw}"] = row
        out["chain_fwd_per_step"] += n * row["plain_fwd"]
        out["chain_bnl_fwd_per_step"] += n * row["bnl_fwd"]
        out["chain_bwd_per_step"] += n * row["plain_bwd"]
    for i, (mod, cin, cout, hw) in enumerate(STATS_SHAPES):
        x, w, *_ = _case(torch, dev, 1440 + i, cin, cout, hw)
        ms = time_ms(torch, lambda: kc.conv3x3_nchw_stats(x, w))
        out["stats"][f"{mod} {cin}->{cout} @{hw}"] = ms
        out["stats_fwd_per_run"] += ms
    return out


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(main(os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                                          else here))), flush=True)
