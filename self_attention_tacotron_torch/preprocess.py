"""Preprocess a corpus into per-utterance source/target TFRecord pairs:
``python -m self_attention_tacotron_torch.preprocess``.

Counterpart of the JAX package's top-level ``preprocess.py``, with the same
arguments. The spectrograms are computed on the card; ``SATT_PLATFORM=cpu``
computes them on the CPU. ``--num-workers`` above 1 runs a pool of worker
processes (started by ``spawn`` on the card).

Usage:
  python -m self_attention_tacotron_torch.preprocess <dataset> <in_dir> <out_dir> \\
      [--hparams=<k=v,...>] [--hparam-json-file=<path>] [--num-workers=<n>] \\
      [--write-selected-lists=<dir>]
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Run the command line ``argv`` (default ``sys.argv[1:]``); returns the
    warnings of the skipped utterances."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dataset", help="ljspeech | vctk | japanese | synthetic")
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("--hparams", default="")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument(
        "--write-selected-lists",
        default=None,
        help="also write train/validation/test id lists to this directory",
    )
    args = p.parse_args(argv)

    from self_attention_tacotron_torch.data.corpus import write_selected_lists
    from self_attention_tacotron_torch.data.dataset_factory import dataset_factory
    from self_attention_tacotron_torch.hparams import default_hparams
    from self_attention_tacotron_torch.utils.platform import platform_device

    device = platform_device()
    hparams = default_hparams()
    if args.hparam_json_file:
        hparams.override_from_json_file(args.hparam_json_file)
    hparams.parse(args.hparams)
    cls = dataset_factory(args.dataset)
    pre = cls(args.in_dir, args.out_dir, hparams, device=device)
    warnings = pre.preprocess(num_workers=args.num_workers)
    for w in warnings:
        print(f"WARNING: {w}")
    if args.write_selected_lists:
        src_ext = "." + hparams.source_file_extension
        ids = [f[: -len(src_ext)] for f in os.listdir(args.out_dir) if f.endswith(src_ext)]
        write_selected_lists(args.write_selected_lists, ids)
    print(f"done: {args.dataset} -> {args.out_dir} on {device}")
    return warnings


if __name__ == "__main__":
    main()
