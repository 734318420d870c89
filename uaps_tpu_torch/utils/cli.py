"""Config flags for the port's entry points: the subset of
`uaps_tpu.train.parse_args` that serving reads, with the same names."""
from __future__ import annotations

import argparse
import dataclasses

from uaps_tpu.utils.config import Config, preset


def parse_args(argv=None):
    """(Config, argparse.Namespace). Unknown flags are left for the
    caller's own parser, as in uaps_tpu.train.parse_args."""
    p = argparse.ArgumentParser(description="uaps_tpu_torch config flags")
    p.add_argument("--preset", default="synthetic",
                   help="neu|dagm|mtiles|kosdd2|synthetic")
    p.add_argument("--method", default=None,
                   help="uaps|baseline|mt|uamt|cps|cct|dct|ucc")
    p.add_argument("--model", default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--n_aux", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--out_dir", default=None)
    p.add_argument("--head_variant", default=None,
                   choices=["taps", "im2col", "dhdw", "dwnp", "dwm",
                            "dwmf", "xla"])
    args, _ = p.parse_known_args(argv)

    if args.preset in ("synthetic", "neu"):
        cfg = preset(args.preset, method=args.method or "uaps")
    else:
        cfg = preset(args.preset)

    def rep(node, **kw):
        return dataclasses.replace(
            node, **{k: v for k, v in kw.items() if v is not None})

    cfg = Config(
        data=rep(cfg.data, num_classes=args.num_classes,
                 batch_size=args.batch_size),
        model=rep(cfg.model, name=args.model, n_aux=args.n_aux,
                  compute_dtype=args.dtype, head_variant=args.head_variant),
        method=rep(cfg.method, name=args.method),
        optim=cfg.optim,
        run=rep(cfg.run, out_dir=args.out_dir),
    )
    return cfg, args
