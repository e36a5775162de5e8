"""Shared CLI argument handling: one flag per ``Config`` field, mapped onto
the dataclass, and the data flags of the trainer (the port's own copy of
``snipper_tpu/cli/common.py:53-155``)."""

from __future__ import annotations

import argparse
import dataclasses
import importlib

from snipper_tpu_torch.config import PRESETS, Config


def _strict_bool(s: str) -> bool:
    """Reject unrecognized values: ``--aux_loss yes`` silently parsing as
    False would disable a loss with no error."""
    if s in ("1", "true", "True"):
        return True
    if s in ("0", "false", "False"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected true/false/1/0 (got {s!r})")


def add_config_args(parser: argparse.ArgumentParser):
    for f in dataclasses.fields(Config):
        if f.type in ("int", int):
            parser.add_argument(f"--{f.name}", type=int, default=None)
        elif f.type in ("float", float):
            parser.add_argument(f"--{f.name}", type=float, default=None)
        elif f.type in ("bool", bool):
            parser.add_argument(f"--{f.name}", type=_strict_bool,
                                default=None)
        else:
            parser.add_argument(f"--{f.name}", type=str, default=None)


def build_config(args) -> Config:
    if args.preset:
        if args.preset not in PRESETS:
            raise SystemExit(f"unknown preset {args.preset!r}; choose from: "
                             f"{', '.join(PRESETS)}")
        cfg = getattr(Config, args.preset)()
    else:
        cfg = Config()
    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = v
    try:
        return cfg.replace(**overrides).validate()
    except ValueError as e:
        raise SystemExit(str(e)) from e


def add_data_args(parser: argparse.ArgumentParser):
    parser.add_argument("--preset", type=str, default=None,
                        help=f"Config preset: {', '.join(PRESETS)}")
    parser.add_argument("--posetrack_dir", type=str, default=None)
    parser.add_argument("--coco_dir", type=str, default=None)
    parser.add_argument("--muco_dir", type=str, default=None)
    parser.add_argument("--jta_dir", type=str, default=None)
    parser.add_argument("--panoptic_dir", type=str, default=None)
    parser.add_argument("--panoptic_protocol", type=int, default=1)
    parser.add_argument("--synthetic", action="store_true",
                        help="use the synthetic dataset (smoke/benchmark; "
                             "the default when no dataset directory is "
                             "given)")
    parser.add_argument("--synthetic_samples", type=int, default=None,
                        help="synthetic dataset size (default 64 train / "
                             "8 val)")
    parser.add_argument("--synthetic_distinct", type=int, default=None,
                        help="limit the synthetic set to N unique samples "
                             "(indices cycle): the overfit-training shape")
    parser.add_argument("--overfit", action="store_true",
                        help="validation set = the training set (same "
                             "synthetic seed)")
    parser.add_argument("--output_dir", type=str, default="./output")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to resume from, or 'auto'/'latest'"
                             " = the newest under {output_dir}/ckpts "
                             "(starts fresh when there is none)")
    parser.add_argument("--pretrained_torch", type=str, default=None,
                        help="a checkpoint of the original Snipper repo")
    parser.add_argument("--pretrained_backbone", type=str, default=None,
                        help="a raw torchvision ResNet .pth; initializes "
                             "only the backbone")
    parser.add_argument("--steps_per_epoch", type=int, default=None)
    parser.add_argument("--num_workers", type=int, default=2,
                        help="threads decoding/warping a batch's samples "
                             "(0 = inline)")


def build_dataset(cfg: Config, args, mode: str,
                  device_preprocess: bool = False):
    """The dataset for ``mode`` ("train" or "val"): ``HybridDataset`` over
    the dataset directories given, or the synthetic set when none is (or
    with ``--synthetic``). ``device_preprocess``: the real datasets emit
    raw frames for the warp inside the train step; the synthetic set
    ignores it, as the JAX CLI does."""
    if args.synthetic or not any((args.posetrack_dir, args.coco_dir,
                                  args.muco_dir, args.jta_dir,
                                  args.panoptic_dir)):
        from snipper_tpu_torch.data.synthetic import SyntheticDataset

        n = args.synthetic_samples or (64 if mode == "train" else 8)
        if device_preprocess:
            print("NOTE: --device_preprocess ignored for the synthetic "
                  "dataset (it renders pre-warped frames directly)",
                  flush=True)
        return SyntheticDataset(
            cfg, n_samples=n,
            seed=0 if (mode == "train" or args.overfit) else 1,
            distinct=args.synthetic_distinct)
    from snipper_tpu_torch.data.datasets import HybridDataset

    return HybridDataset(
        cfg, mode=mode, posetrack_dir=args.posetrack_dir,
        coco_dir=args.coco_dir, muco_dir=args.muco_dir,
        jta_dir=args.jta_dir, panoptic_dir=args.panoptic_dir,
        panoptic_protocol=args.panoptic_protocol,
        device_preprocess=device_preprocess)


def load_state(parser: argparse.ArgumentParser, args, cfg: Config):
    """``(cfg, state_dict)`` for the serving and eval CLIs: the checkpoint
    of ``--pretrained_torch`` or ``--resume`` (a trainer checkpoint's
    ``params``) read under ``cfg``, then, with ``--fast``, the profile's
    config and the state dict mapped to it (``infer/fast.py``). Without a
    checkpoint the state dict is None: the caller seeds a model under the
    returned config, which is already profile-shaped."""
    transform = None
    load_cfg = cfg
    if getattr(args, "fast", None):
        from snipper_tpu_torch.infer.fast import fast_profiles

        try:
            cfg, transform = fast_profiles(cfg, args.fast)
        except ValueError as e:
            parser.error(str(e))
    state = None
    if args.pretrained_torch:
        from snipper_tpu_torch.convert import load_reference_checkpoint

        state = load_reference_checkpoint(args.pretrained_torch, load_cfg)
    elif args.resume:
        from snipper_tpu_torch.train.checkpoint import load_checkpoint

        state = load_checkpoint(args.resume)["params"]
    if state is not None and transform is not None:
        state = transform(state)
    return cfg, state


def _console_entry(name: str):
    """The console script of ``cli.<name>``: its ``main()`` returns a result
    dict, which ``sys.exit`` would take for a failure, so the script's
    function returns None."""
    def run() -> None:
        importlib.import_module(f"snipper_tpu_torch.cli.{name}").main()

    return run


train_main, eval_main, infer_main, export_main, dump_labels_main = (
    _console_entry(n)
    for n in ("train", "eval", "infer", "export", "dump_labels"))
