"""Export the model forward as a self-contained ``torch.export`` serving
artifact (counterpart of ``snipper_tpu/cli/export.py``).

    python -m snipper_tpu_torch.cli.export --preset canonical_t4 \\
        --resume CKPT.pt --output model.pt2 [--fast enc4,p2,r480] \\
        [--param_dtype bfloat16] [--batch_size B]

The artifact holds the weights; a server reads it with
``snipper_tpu_torch.infer.export.load_exported`` (which registers the MSDA
operators and imports no model code) and calls it on ``[B, T, H, W, 3]``
float32 snippets. It is traced on, and runs on, the GPU unless ``--device
cpu`` (or ``--platforms cpu``) is given. ``--fast`` takes the serving
profiles r, enc and p; m{N} is refused, as the JAX CLI refuses it
(JAX's artifact cannot run its exactness cascade; the port's sampling
has no margin at all).
"""

from __future__ import annotations

import argparse

from snipper_tpu_torch.cli.common import (add_config_args, build_config,
                                          load_state)
from snipper_tpu_torch.infer.export import (export_forward, resolve_platform,
                                            save_exported)
from snipper_tpu_torch.infer.fast import PROFILE_HELP, fast_profiles


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("snipper_tpu_torch export")
    add_config_args(parser)
    parser.add_argument("--preset", type=str, default="canonical_t4")
    parser.add_argument("--output", type=str, required=True,
                        help="artifact path (e.g. model.pt2)")
    parser.add_argument("--resume", type=str, default=None,
                        help="a checkpoint of this port's trainer (its "
                             "'params' are embedded)")
    parser.add_argument("--pretrained_torch", type=str, default=None,
                        help="a checkpoint of the original Snipper repo to "
                             "embed")
    # --batch_size comes from add_config_args; here it sets the artifact's
    # (static) serving batch, 1 by default
    parser.add_argument("--platforms", type=str, default=None,
                        help="the device to trace for: cuda (or gpu) or "
                             "cpu; default --device")
    parser.add_argument("--param_dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="store the weights at this dtype (bfloat16 "
                             "halves the artifact, which then computes in "
                             "bf16 on the f32 images cast to bf16)")
    parser.add_argument("--fast", type=str, default=None, help=PROFILE_HELP)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    """Export; returns ``{"path", "bytes", "device", "batch"}``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    platforms = ([p for p in args.platforms.split(",") if p.strip()]
                 if args.platforms else None)
    try:
        device = resolve_platform(platforms, args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.fast:
        # parse first, so that an unknown profile gets its own error
        try:
            fast_profiles(build_config(args), args.fast)
        except ValueError as e:
            parser.error(str(e))
        if any(s.strip().startswith("m") for s in args.fast.split(",")):
            parser.error("--fast m{N} is refused for an exported artifact, "
                         "as the JAX export refuses it; use r/enc/p "
                         "profiles (the port's sampling is exact at any "
                         "margin)")
    from snipper_tpu_torch.models.snipper import resolve_device

    resolve_device(device)
    cfg, state = load_state(parser, args, build_config(args))
    batch = args.batch_size if args.batch_size is not None else 1
    exported = export_forward(cfg, state, batch_size=batch, device=device,
                              param_dtype=args.param_dtype)
    size = save_exported(exported, args.output)
    print(f"exported {args.preset} (msda_forward, batch={batch}, "
          f"platforms=['{device}'], param_dtype={args.param_dtype}) -> "
          f"{args.output} ({size / 1e6:.1f} MB)", flush=True)
    return {"path": args.output, "bytes": size, "device": device,
            "batch": batch}


if __name__ == "__main__":
    main()
