"""Config flags for the port's entry points: `uaps_tpu.train.parse_args`'s
flags with the same names and the same overrides of the preset, plus
`--dataset`, which picks the data source (`synthetic` trains on the
port's `SyntheticDefects` at the preset's image size and batch)."""
from __future__ import annotations

import argparse
import dataclasses

from uaps_tpu_torch.utils.config import Config, preset


def parse_args(argv=None):
    """(Config, argparse.Namespace). Unknown flags are left for the
    caller's own parser (--ckpt, --port, --device, ...)."""
    p = argparse.ArgumentParser(description="uaps_tpu_torch config flags")
    p.add_argument("--preset", default="synthetic",
                   help="neu|dagm|mtiles|kosdd2|synthetic")
    p.add_argument("--method", default=None,
                   help="uaps|baseline|mt|uamt|cps|cct|dct|ucc")
    p.add_argument("--model", default=None)
    p.add_argument("--dataset", default=None,
                   help="data source; 'synthetic' for SyntheticDefects")
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--iter_per_epoch", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--base_lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--labeled_fraction", type=float, default=None)
    p.add_argument("--consistency1", type=float, default=None)
    p.add_argument("--consistency2", type=float, default=None)
    p.add_argument("--consistency_rampup", type=float, default=None)
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--n_aux", type=int, default=None)
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--out_dir", default=None)
    p.add_argument("--image_root", default=None)
    p.add_argument("--mask_root", default=None)
    p.add_argument("--test_image_root", default=None)
    p.add_argument("--test_mask_root", default=None)
    p.add_argument("--fused_batch", action="store_true")
    p.add_argument("--stack_decoders", action="store_true")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--head_variant", default=None,
                   choices=["taps", "im2col", "dhdw", "dwnp", "dwm",
                            "dwmf", "xla"])
    p.add_argument("--early_stop_patience", type=int, default=None)
    p.add_argument("--dropout_backend", default=None,
                   choices=["auto", "xla", "pallas"])
    p.add_argument("--steps_per_dispatch", type=int, default=None,
                   help="K > 1 runs K steps per dispatch (one CUDA graph "
                        "on the GPU); 0: 4 on the GPU, 1 on the CPU")
    p.add_argument("--device_pools", action="store_true",
                   help="sample batches on the device from the data's "
                        "fixed pools (data/device_pool.py)")
    p.add_argument("--debug_nans", action="store_true",
                   help="single eager steps that raise FloatingPointError "
                        "at the first NaN (train.py)")
    args, _ = p.parse_known_args(argv)

    if args.preset in ("synthetic", "neu"):
        cfg = preset(args.preset, method=args.method or "uaps")
    else:
        cfg = preset(args.preset)

    def rep(node, **kw):
        return dataclasses.replace(
            node, **{k: v for k, v in kw.items() if v is not None})

    cfg = Config(
        data=rep(cfg.data, name=args.dataset, num_classes=args.num_classes,
                 batch_size=args.batch_size,
                 labeled_fraction=args.labeled_fraction,
                 image_root=args.image_root, mask_root=args.mask_root,
                 test_image_root=args.test_image_root,
                 test_mask_root=args.test_mask_root),
        model=rep(cfg.model, name=args.model, n_aux=args.n_aux,
                  compute_dtype=args.dtype,
                  stack_decoders=args.stack_decoders or None,
                  head_variant=args.head_variant,
                  dropout_backend=args.dropout_backend,
                  remat=args.remat or None),
        method=rep(cfg.method, name=args.method,
                   consistency1=args.consistency1,
                   consistency2=args.consistency2,
                   consistency_rampup=args.consistency_rampup,
                   ema_decay=args.ema_decay,
                   fused_batch=args.fused_batch or None),
        optim=rep(cfg.optim, base_lr=args.base_lr),
        run=rep(cfg.run, epochs=args.epochs,
                iter_per_epoch=args.iter_per_epoch, seed=args.seed,
                out_dir=args.out_dir,
                early_stop_patience=args.early_stop_patience,
                steps_per_dispatch=args.steps_per_dispatch,
                device_pools=args.device_pools or None,
                debug_nans=args.debug_nans or None),
    )
    return cfg, args
