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
    `chain_bnl_fwd_per_step`, `chain_bwd_per_step`), and the backward of
    `chain_conv_bnl` (the fold, the dgrad with the BN prologue's backward
    and df/ds, the wgrad) summed alike (`chain_bnl_bwd_per_step`) beside
    autograd of the library composite (the torch normalise, leaky and
    `F.dropout`, then `F.conv2d`: `chain_bnl_bwd_library_per_step`);
  * `conv3x3_bnl` at the fused step's two shapes, summed over its 16
    launches (`bnl_fwd_per_step`; its backward `bnl_bwd_per_step`, beside
    autograd of normalise, leaky and `F.conv2d`:
    `bnl_bwd_library_per_step`), and the stats conv
    (`conv3x3_nchw_stats`) at the bn_stats blocks' four convs, summed
    (`stats_fwd_per_run`);
  * the NHWC conv (`kernels/conv3x3.py`) at NHWC_SHAPE: `conv3x3_forward`
    and `conv3x3_dgrad` (`nhwc_fwd`, `nhwc_dgrad`) and cuDNN's forward
    and `conv2d_input` on the channels_last views of the same tensors
    (`nhwc_cudnn_fwd`, `nhwc_cudnn_dgrad`);
  * the dropout kernel (`kernels/perturb.py` `_dropout`, p = 0.5) at the 5
    encoder levels of a neu UAPS step, summed over its 8 launches a level
    (`dropout_per_step`), beside `F.dropout` on the same tensors
    (`dropout_library_per_step`), each call timed alone after a 256 MiB
    write has flushed the L2 (chip_smoke.py phase 11's timing); and
    `dropout_sass`: the instructions of the bf16 dropout kernel's loop
    that holds its global loads, per element, read from `cuobjdump -sass`
    of ROOT's built library, with the integer-issue floor they set a step
    (the integer instructions x the step's elements over the SMs' integer
    lanes at the card's maximum SM clock);
  * the feature-noise kernel (`_noise`, r = 0.3) at the same 5 levels,
    summed over its 4 launches a level (`noise_per_step`), timed as
    dropout;
  * the feature-dropout forward (`_fdrop_fwd`: the max or attention pass
    and the apply pass) and backward (`_fdrop_bwd`) at the same 5 levels,
    each summed over its 2 launches a level (`fdrop_fwd_per_step`,
    `fdrop_bwd_per_step`), timed as dropout, through ROOT's own API (since
    the attention pass the backward takes the forward's attention and
    maxima, before it x and the maxima);
  * the CE+Dice forward (`ce_dice_stats`) and backward (`ce_dice_bwd`) on
    f32 logits [16, 256, 256, 4] (the NHWC view of the head's NCHW
    output) and int32 labels, one call each (`ce_dice_fwd`,
    `ce_dice_bwd`) and per UAPS step (8 launches each:
    `ce_dice_fwd_per_step`, `ce_dice_bwd_per_step`); the uncertainty
    forward (`uncertainty_fwd`) and backward (`uncertainty_bwd`) on 4 such
    logits, and the pseudo-label kernel (`fused_pseudo_label`,
    `pseudo_label`) on the same logits, all timed as dropout; the two
    forwards also after a read flush that leaves the L2 clean
    (`ce_dice_fwd_clean`, `uncertainty_fwd_clean`), and the two events
    with no call between them (`events_only`).
Each conv time is the median over 5 rounds of CUDA events around 20
back-to-back calls queued behind a ~2.5 ms spin, so that the host's enqueue
is not counted (chip_smoke.py `Smoke.time_ms`). Two separate runs may land
on two different cards: compare checkouts within one run, in turns (A, B,
B, A). Needs a CUDA card.
"""
from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import statistics
import subprocess
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
# the NHWC conv's shape (chip_smoke.py NHWC_SHAPE): (B, H, W, Cin, Cout)
NHWC_SHAPE = (16, 256, 256, 16, 16)
# the encoder levels of a neu UAPS step (chip_smoke.py LEVELS): (channels,
# H = W); the dropout kernel runs 8 times a level a step (PER_LEVEL)
LEVELS = [(16, 256), (32, 128), (64, 64), (128, 32), (256, 16)]
DROPOUT_PER_LEVEL = 8
NOISE_PER_LEVEL = 4
FDROP_PER_LEVEL = 2
# the loss logits of a neu step: [B, H, W, C] f32; CE+Dice launches a UAPS
# step each way (4 decoders x the labelled and the pseudo-labelled batch);
# the decoders the uncertainty and pseudo-label kernels mix
LOSS_SHAPE = (BATCH, 256, 256, 4)
CE_DICE_PER_STEP = 8
N_DEC = 4
# integer lanes an H100 SM issues a clock (4 partitions of 16 INT32 units;
# the CUDA programming guide's throughput table for compute capability 9.0)
INT_LANES_PER_SM = 64


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


def cold_ms(torch, fn, calls=100, warmup=3, clean=False):
    """Median device time of one fn() call, each timed alone with CUDA
    events after a 256 MiB write has flushed the 50 MB L2, then a ~0.5 ms
    spin that touches no memory, so that the device is still busy while
    the host queues the call (chip_smoke.py `Smoke.time_ms(cold=True)`).
    The write leaves the L2 full of dirty lines, which the call then
    writes back as it evicts them; with `clean`, a 256 MiB read flushes it
    instead and leaves it clean."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(calls):
        if clean:
            flush.sum(dtype=torch.int32)
        else:
            flush.zero_()
        torch.cuda._sleep(1_000_000)   # cycles, ~0.5 ms
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# SASS opcodes (the part before the first '.') issued to the integer lanes
INT_OPS = {"IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
           "ISETP", "LEA", "SEL", "PRMT", "IMNMX", "IABS", "VIADD", "VIMNMX",
           "POPC", "FLO", "BREV", "BMSK", "SGXT", "IMUL"}
# bytes a global load moves, by its width suffix
LDG_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}


def sass_loop(body):
    """(instructions, elements, integer instructions) of one iteration of
    the loop that moves the most global-load bytes in one bf16 kernel's
    SASS listing: the longest path from the loop's head to its backward
    branch (the compiler may give an iteration alternative paths, such as
    one that skips the hash where every element is kept; the longest is
    the one that does all the work), NOPs not counted, elements = the
    path's load bytes / 2. Branch targets are addresses or labels."""
    ops, at = [], {}
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            at[m.group(1)] = len(ops)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T\d]+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if m:
            at[int(m.group(1), 16)] = len(ops)
            ops.append((m.group(3), m.group(4), bool(m.group(2))))

    def target(args):
        t = re.search(r"(\.L_x_\d+)|0x([0-9a-f]+)", args)
        return at.get(t.group(1) or int(t.group(2), 16)) if t else None

    def cost(op):   # (instructions, load bytes, integer instructions)
        if op == "NOP":
            return (0, 0, 0)
        nbytes = (next((LDG_BYTES[w] for w in op.split(".")
                        if w in LDG_BYTES), 4) if op.startswith("LDG") else 0)
        return (1, nbytes, int(op.split(".")[0] in INT_OPS))

    best = None
    for j, (op, args, _) in enumerate(ops):
        i = target(args) if op.startswith("BRA") else None
        if i is None or i > j:
            continue
        # longest path i -> j over the loop's forward edges
        dist = {i: cost(ops[i][0])}
        for k in range(i, j):
            if k not in dist:
                continue
            op_k, args_k, pred = ops[k]
            succ = []
            if not (op_k.startswith(("BRA", "EXIT")) and not pred):
                succ.append(k + 1)
            t = target(args_k) if op_k.startswith("BRA") else None
            if t is not None and k < t <= j:
                succ.append(t)
            for n in succ:
                c = tuple(a + b for a, b in zip(dist[k], cost(ops[n][0])))
                if n not in dist or c > dist[n]:
                    dist[n] = c
        path = dist.get(j)
        if path and path[1] and (best is None or path[1] > best[1]):
            best = path
    n_all, nbytes, n_int = best
    return n_all, nbytes // 2, n_int


def dropout_sass(root, elements, sms):
    """The bf16 dropout kernel's load loop (sass_loop) from `cuobjdump
    -sass` of ROOT's libperturb.so: instructions and integer instructions
    per element, and the floors those set on `elements` elements at the
    card's maximum SM clock: integer issue (INT_LANES_PER_SM lanes an SM a
    clock) and all issue (128 lanes: 4 warp instructions an SM a clock).
    The kernel's listing goes to chiprun_out/dropout_<root's name>.sass."""
    lib = os.path.join(root, "uaps_tpu_torch", "build", "libperturb.so")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", text)
                if re.match(r"\S*dropout_kernelI13__nv_bfloat16", f))
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "dropout_" + os.path.basename(root)
                           + ".sass"), "w") as f:
        f.write(body)
    n_all, per, n_int = sass_loop(body)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    lanes_hz = sms * mhz * 1e6
    return {"loop_instructions": n_all, "elements": per,
            "instructions_per_element": n_all / per,
            "int_per_element": n_int / per, "max_sm_clock_mhz": mhz,
            "int_floor_ms": n_int / per * elements
            / (INT_LANES_PER_SM * lanes_hz) * 1e3,
            "issue_floor_ms": n_all / per * elements / (128 * lanes_hz) * 1e3}


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


def composite_bwd(torch, x, f, s, w, rate):
    """A backward of the library's composite of the chain bnl conv and of
    conv3x3_bnl: autograd through leaky(x f + s), F.dropout (rate > 0) and
    F.conv2d, as chip_smoke.py phase 14 times it: g -> the gradients of x,
    f, s and w."""
    import torch.nn.functional as F
    ins = [t.detach().clone().requires_grad_() for t in (x, f, s)]
    w_oihw = w.permute(3, 2, 0, 1).contiguous().requires_grad_()
    z = F.leaky_relu(ins[0].float() * ins[1][:, None, None]
                     + ins[2][:, None, None], 0.01)
    if rate > 0:
        z = F.dropout(z, rate)
    out = F.conv2d(z.to(x.dtype), w_oihw, padding=1)
    return lambda g: torch.autograd.grad(out, [*ins, w_oihw], g,
                                         retain_graph=True)


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
    import torch.nn.functional as F
    from uaps_tpu_torch.kernels import conv3x3 as kn
    from uaps_tpu_torch.kernels import perturb as kpt
    _build.build(["conv3x3_nchw", "conv3x3_wgrad_nchw", "block_conv",
                  "conv3x3_nhwc", "perturb"])
    dev, bf = torch.device("cuda:0"), torch.bfloat16
    sums = ("fwd", "dgrad", "wgrad", "fwd_fullh_per_step",
            "dgrad_fullh_per_step", "wgrad_fullh_per_step",
            "chain_fwd_per_step", "chain_bnl_fwd_per_step",
            "chain_bwd_per_step", "chain_bnl_bwd_per_step",
            "chain_bnl_bwd_library_per_step", "bnl_fwd_per_step",
            "bnl_bwd_per_step", "bnl_bwd_library_per_step",
            "stats_fwd_per_run")
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
        z, w2, g2, f, s, ds1, ds2, sd = _case(torch, dev, 1420 + i, cout,
                                              cout, hw)
        y2 = kbc.chain_conv_bnl(z, f, s, w2, sd, rate)[0]
        row["bnl_fwd"] = time_ms(
            torch, lambda: kbc.chain_conv_bnl(z, f, s, w2, sd, rate))
        row["bnl_bwd"] = time_ms(torch, lambda: kbc._backward(
            g2, ds1, ds2, y2, z, f, s, w2, sd, rate, True))
        lib_b = composite_bwd(torch, z, f, s, w2, rate)
        row["bnl_bwd_library"] = time_ms(torch, lambda: lib_b(g2))
        out["chain_bnl_bwd_per_step"] += n * row["bnl_bwd"]
        out["chain_bnl_bwd_library_per_step"] += n * row["bnl_bwd_library"]
        if rate == 0:
            row["conv3x3_bnl"] = time_ms(
                torch, lambda: kbnl.conv3x3_bnl(z, f, s, w2))
            row["conv3x3_bnl_bwd"] = time_ms(
                torch, lambda: kbnl._backward(g2, z, f, s, w2))
            out["bnl_fwd_per_step"] += n * row["conv3x3_bnl"]
            out["bnl_bwd_per_step"] += n * row["conv3x3_bnl_bwd"]
            out["bnl_bwd_library_per_step"] += n * row["bnl_bwd_library"]
        out["chain"][f"{blk} {cin}->{cout}->{cout} @{hw}"] = row
        out["chain_fwd_per_step"] += n * row["plain_fwd"]
        out["chain_bnl_fwd_per_step"] += n * row["bnl_fwd"]
        out["chain_bwd_per_step"] += n * row["plain_bwd"]
    for i, (mod, cin, cout, hw) in enumerate(STATS_SHAPES):
        x, w, *_ = _case(torch, dev, 1440 + i, cin, cout, hw)
        ms = time_ms(torch, lambda: kc.conv3x3_nchw_stats(x, w))
        out["stats"][f"{mod} {cin}->{cout} @{hw}"] = ms
        out["stats_fwd_per_run"] += ms
    b, h, wd, cin, cout = NHWC_SHAPE
    g = torch.Generator(device=dev).manual_seed(1460)
    x = torch.randn((b, h, wd, cin), generator=g, device=dev).to(bf)
    w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
         / (9 * cin) ** 0.5).to(bf)
    gy = torch.randn((b, h, wd, cout), generator=g, device=dev).to(bf)
    xl, gl = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)  # channels_last
    wl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    out["nhwc_fwd"] = time_ms(torch, lambda: kn.conv3x3_forward(x, w))
    out["nhwc_dgrad"] = time_ms(torch, lambda: kn.conv3x3_dgrad(gy, w))
    out["nhwc_cudnn_fwd"] = time_ms(torch,
                                    lambda: F.conv2d(xl, wl, padding=1))
    out["nhwc_cudnn_dgrad"] = time_ms(torch, lambda: torch.nn.grad.
                                      conv2d_input(xl.shape, wl, gl,
                                                   padding=1))
    out["dropout"], out["dropout_library"] = {}, {}
    out["dropout_per_step"] = out["dropout_library_per_step"] = 0.0
    elements = 0
    for i, (c, hw) in enumerate(LEVELS):
        g = torch.Generator(device=dev).manual_seed(1480 + i)
        x = torch.randn((BATCH, c, hw, hw), generator=g, device=dev).to(bf)
        sd = torch.randint(0, 2 ** 31 - 1, (), generator=g, device=dev)
        label = f"[{BATCH},{c},{hw},{hw}]"
        ms = cold_ms(torch, lambda: kpt._dropout(x, sd, 0.5))
        lib = cold_ms(torch, lambda: F.dropout(x, 0.5, training=True))
        out["dropout"][label], out["dropout_library"][label] = ms, lib
        out["dropout_per_step"] += DROPOUT_PER_LEVEL * ms
        out["dropout_library_per_step"] += DROPOUT_PER_LEVEL * lib
        elements += DROPOUT_PER_LEVEL * x.numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["dropout_sass"] = dropout_sass(root, elements, sms)
    out["noise"], out["noise_per_step"] = {}, 0.0
    for i, (c, hw) in enumerate(LEVELS):
        g = torch.Generator(device=dev).manual_seed(1500 + i)
        x = torch.randn((BATCH, c, hw, hw), generator=g, device=dev).to(bf)
        sd = torch.randint(0, 2 ** 31 - 1, (), generator=g, device=dev)
        ms = cold_ms(torch, lambda: kpt._noise(x, sd, 0.3))
        out["noise"][f"[{BATCH},{c},{hw},{hw}]"] = ms
        out["noise_per_step"] += NOISE_PER_LEVEL * ms
    out["fdrop_fwd"], out["fdrop_bwd"] = {}, {}
    out["fdrop_fwd_per_step"] = out["fdrop_bwd_per_step"] = 0.0
    saves_att = "att" in inspect.signature(kpt._fdrop_bwd).parameters
    for i, (c, hw) in enumerate(LEVELS):
        g = torch.Generator(device=dev).manual_seed(1520 + i)
        x, gy = (torch.randn((BATCH, c, hw, hw), generator=g,
                             device=dev).to(bf) for _ in range(2))
        sd = torch.randint(0, 2 ** 31 - 1, (), generator=g, device=dev)
        res = kpt._fdrop_fwd(x, sd)
        if saves_att:   # (out, att, mx); the backward from att and mx
            def bwd():
                return kpt._fdrop_bwd(gy, sd, res[1], res[2])
        else:           # (out, mx); the backward from x and mx
            def bwd():
                return kpt._fdrop_bwd(x, gy, sd, res[1])
        label = f"[{BATCH},{c},{hw},{hw}]"
        fwd_ms = cold_ms(torch, lambda: kpt._fdrop_fwd(x, sd))
        bwd_ms = cold_ms(torch, bwd)
        out["fdrop_fwd"][label], out["fdrop_bwd"][label] = fwd_ms, bwd_ms
        out["fdrop_fwd_per_step"] += FDROP_PER_LEVEL * fwd_ms
        out["fdrop_bwd_per_step"] += FDROP_PER_LEVEL * bwd_ms
    from uaps_tpu_torch.kernels import ce_dice as kce
    from uaps_tpu_torch.kernels import pseudo_label as kpl
    from uaps_tpu_torch.kernels import uncertainty as kun
    _build.build(["ce_dice", "uncertainty", "pseudo_label"])
    b, h, wd, c = LOSS_SHAPE
    g = torch.Generator(device=dev).manual_seed(1540)
    lg = (torch.randn((b, c, h, wd), generator=g, device=dev)
          * 2).permute(0, 2, 3, 1)
    labels = torch.randint(0, c, (b, h, wd), generator=g, device=dev,
                           dtype=torch.int32)
    q, gce = kce.bwd_coefs(kce.ce_dice_stats(lg, labels), 0.5, 0.5,
                           labels.numel())
    out["ce_dice_fwd"] = cold_ms(torch, lambda: kce.ce_dice_stats(lg, labels))
    out["ce_dice_bwd"] = cold_ms(torch,
                                 lambda: kce.ce_dice_bwd(lg, labels, q, gce))
    out["ce_dice_fwd_per_step"] = CE_DICE_PER_STEP * out["ce_dice_fwd"]
    out["ce_dice_bwd_per_step"] = CE_DICE_PER_STEP * out["ce_dice_bwd"]
    logits = [(torch.randn((b, c, h, wd), generator=g, device=dev)
               * 3).permute(0, 2, 3, 1) for _ in range(N_DEC)]
    w = torch.empty(N_DEC, device=dev).exponential_(generator=g)
    w = w / w.sum()
    gv = torch.randn((N_DEC, b, h, wd), generator=g, device=dev)
    out["uncertainty_fwd"] = cold_ms(
        torch, lambda: kun.uncertainty_fwd(logits, w))
    out["uncertainty_bwd"] = cold_ms(
        torch, lambda: kun.uncertainty_bwd(logits, gv))
    out["pseudo_label"] = cold_ms(
        torch, lambda: kpl.fused_pseudo_label(logits, w))
    # what the dirty L2 and the two events cost those times
    out["ce_dice_fwd_clean"] = cold_ms(
        torch, lambda: kce.ce_dice_stats(lg, labels), clean=True)
    out["uncertainty_fwd_clean"] = cold_ms(
        torch, lambda: kun.uncertainty_fwd(logits, w), clean=True)
    out["events_only"] = cold_ms(torch, lambda: None)
    return out


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(main(os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                                          else here))), flush=True)
