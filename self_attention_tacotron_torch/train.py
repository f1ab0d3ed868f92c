"""Train a Tacotron model: ``python -m self_attention_tacotron_torch.train``.

Counterpart of the JAX package's top-level ``train.py``, with the same flags.
Runs on the card; ``SATT_PLATFORM=cpu`` runs it on the CPU. Checkpoints go to
``--checkpoint-dir`` (auto-resume from the latest one there), scalars and PNGs
to ``--log-dir`` (default ``<checkpoint-dir>/log``). ``--restore-from`` warm
starts from a flat ``.npz`` of the JAX layout or from another run's checkpoint
directory. A run with nothing to restore starts from weights drawn with flax's
initialisers from ``random_seed`` (``Trainer.init_state``), as the JAX CLI's do, and
shuffles its batches from that seed too: the same seed, the same run.

Under ``torchrun --standalone --nproc_per_node=N`` each rank takes ``cuda:LOCAL_RANK``
(``SATT_PLATFORM=cpu``: the CPU, with gloo) and trains data-parallel over the
mesh ``--hparams=mesh_shape=D+M`` (default: every rank on ``data``); every rank
reads the same batches, and rank 0 writes the checkpoints, logs and PNGs.

Usage:
  python -m self_attention_tacotron_torch.train --source-data-root=<dir> \\
      [--target-data-root=<dir>] --checkpoint-dir=<dir> [--selected-list-dir=<dir>] \\
      [--dataset=<name>] [--hparams=<k=v,...>] [--hparam-json-file=<path>] \\
      [--steps=<n>] [--log-dir=<dir>] [--restore-from=<npz or dir>]
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source-data-root", required=True)
    p.add_argument("--target-data-root", default=None)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--selected-list-dir", default=None)
    p.add_argument("--selected-list-filename", default="train")
    p.add_argument("--validation-list-filename", default="validation")
    p.add_argument("--dataset", default=None, help="overrides hparams.dataset")
    p.add_argument("--hparams", default="", help="comma-separated k=v overrides")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--steps", type=int, default=100000)
    p.add_argument("--log-dir", default=None)
    p.add_argument(
        "--restore-from",
        default=None,
        help="warm-start params from a flat .npz or another run's checkpoint dir (fine-tuning)",
    )
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line ``argv`` (default ``sys.argv[1:]``); returns the final
    ``TrainState``."""
    args = parse_args(argv)
    from self_attention_tacotron_torch.data.dataset import TacotronDataset, read_selected_list
    from self_attention_tacotron_torch.hparams import default_hparams
    from self_attention_tacotron_torch.models.models import tacotron_model_factory
    from self_attention_tacotron_torch.parallel import init_from_env
    from self_attention_tacotron_torch.training.trainer import Trainer

    device = init_from_env()
    hparams = default_hparams()
    if args.hparam_json_file:
        hparams.override_from_json_file(args.hparam_json_file)
    hparams.parse(args.hparams)
    if args.dataset:
        hparams.dataset = args.dataset

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    log = logging.getLogger("self_attention_tacotron_torch.train")
    log.setLevel(logging.INFO)
    chief = int(os.environ.get("RANK", "0")) == 0
    handlers = [logging.StreamHandler(),
                logging.FileHandler(os.path.join(args.checkpoint_dir, hparams.logfile))
                ] if chief else []
    for handler in handlers:
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        log.addHandler(handler)
    try:
        log.info("hparams: %s", hparams.to_json())
        target_root = args.target_data_root or args.source_data_root
        train_ids = eval_ids = None
        if args.selected_list_dir:
            train_ids = read_selected_list(args.selected_list_dir, args.selected_list_filename)
            try:
                eval_ids = read_selected_list(args.selected_list_dir,
                                              args.validation_list_filename)
            except FileNotFoundError:
                eval_ids = None
        train_data = TacotronDataset(args.source_data_root, target_root, hparams,
                                     utterance_ids=train_ids)
        eval_data = (
            TacotronDataset(args.source_data_root, target_root, hparams, utterance_ids=eval_ids)
            if eval_ids else None
        )
        model = tacotron_model_factory(hparams)
        trainer = Trainer(model, args.checkpoint_dir, log_dir=args.log_dir, device=device)
        log.info("training %s on %s (%d train utterances) on %s", hparams.tacotron_model,
                 hparams.dataset, len(train_data), device)
        state = trainer.train(
            train_data.batches(hparams.batch_size, shuffle=True, repeat=True,
                               seed=hparams.random_seed),
            num_steps=args.steps,
            eval_batches_fn=(
                (lambda: eval_data.batches(hparams.batch_size, shuffle=False, repeat=False))
                if eval_data else None
            ),
            warm_start_from=args.restore_from,
        )
        log.info("training complete at step %d", state.step)
        return state
    finally:
        for handler in handlers:
            log.removeHandler(handler)
            handler.close()


if __name__ == "__main__":
    main()
