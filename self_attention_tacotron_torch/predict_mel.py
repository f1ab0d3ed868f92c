"""Synthesize mel spectrograms for a test list:
``python -m self_attention_tacotron_torch.predict_mel``.

Counterpart of the JAX package's top-level ``predict_mel.py``, with the same
flags. Restores the parameters of the latest checkpoint of ``--checkpoint-dir``
(``Trainer.restore_inference``) and decodes through ``make_predict_fn`` on the
card (``SATT_PLATFORM=cpu``: on the CPU). Per utterance it writes the predicted
mel as raw float32 (``<id>.mfbsp``; the WORLD heads ``<id>.mgc`` and the lf0
classes as int32 ``<id>.lf0``), an alignment PNG and a mel PNG; an id repeated in
the padded tail of the last batch is written once. ``--hparams=
use_forced_alignment_mode=true`` switches the attention to the teacher-forcing
window over the ground-truth lengths, marks every output as reconstructed and
writes ``FORCED_ALIGNMENT_NOTE.txt``. ``--write-wav`` adds a Griffin-Lim
waveform from the predicted linear spectrogram (only with
``use_linear_spectrogram_postnet``).

Under ``torchrun --standalone --nproc_per_node=N`` each rank takes ``cuda:LOCAL_RANK``
and the batch is split over the N ranks (``make_sharded_predict_fn``) where the batch
size divides N, as the JAX CLI shards it over its devices; rank 0 writes the files.

Usage:
  python -m self_attention_tacotron_torch.predict_mel --source-data-root=<dir> \\
      [--target-data-root=<dir>] --checkpoint-dir=<dir> --output-dir=<dir> \\
      [--selected-list-dir=<dir>] [--test-list-filename=<name>] \\
      [--hparams=<k=v,...>] [--hparam-json-file=<path>] [--batch-size=<n>] [--write-wav]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional, Sequence

FORCED_ALIGNMENT_WARNING = (
    "[predict_mel] WARNING: use_forced_alignment_mode uses RECONSTRUCTED, UNVERIFIED "
    "teacher-forcing attention semantics (see models/attention.py TeacherForcingAttention "
    "docstring)"
)
FORCED_ALIGNMENT_NOTE = (
    "Outputs in this directory were produced with use_forced_alignment_mode=true.\n"
    "The teacher-forcing attention is a RECONSTRUCTION (Gaussian window sliding at the "
    "source/target length ratio); the reference's exact semantics could not be verified. "
    "Treat alignments/predictions from this mode as unverified against the reference.\n"
)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Run the command line ``argv`` (default ``sys.argv[1:]``); returns ``frames``,
    the predicted frames of each utterance written, and ``synthesis_s``, the seconds
    from each batch's feed to its outputs on the host, summed."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source-data-root", required=True)
    p.add_argument("--target-data-root", default=None)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--selected-list-dir", default=None)
    p.add_argument("--test-list-filename", default="test")
    p.add_argument("--hparams", default="")
    p.add_argument("--hparam-json-file", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument(
        "--write-wav",
        action="store_true",
        help="Griffin-Lim a waveform from the predicted linear spectrogram "
        "(requires use_linear_spectrogram_postnet=true)",
    )
    args = p.parse_args(argv)

    import numpy as np

    from self_attention_tacotron_torch.data.dataset import TacotronDataset, read_selected_list
    from self_attention_tacotron_torch.hparams import default_hparams
    from self_attention_tacotron_torch.models.models import tacotron_model_factory
    from self_attention_tacotron_torch.parallel import init_from_env, make_mesh
    from self_attention_tacotron_torch.synthesis import make_predict_fn, make_sharded_predict_fn
    from self_attention_tacotron_torch.training.metrics import (
        image_writer,
        save_alignment_png,
        save_mel_comparison_png,
    )
    from self_attention_tacotron_torch.training.trainer import Trainer, step_generator

    device = init_from_env()
    hparams = default_hparams()
    if args.hparam_json_file:
        hparams.override_from_json_file(args.hparam_json_file)
    hparams.parse(args.hparams)
    if hparams.use_forced_alignment_mode and not hparams.attention.startswith("teacher_forcing"):
        hparams.attention = "teacher_forcing_" + hparams.attention
    if hparams.use_forced_alignment_mode:
        print(FORCED_ALIGNMENT_WARNING, flush=True)
    audio = None
    if args.write_wav:
        if not hparams.use_linear_spectrogram_postnet:
            raise SystemExit(
                "--write-wav requires --hparams=use_linear_spectrogram_postnet=true"
            )
        from self_attention_tacotron_torch.audio import Audio

        audio = Audio(hparams, device=device)

    target_root = args.target_data_root or args.source_data_root
    ids = None
    if args.selected_list_dir:
        ids = read_selected_list(args.selected_list_dir, args.test_list_filename)
    data = TacotronDataset(args.source_data_root, target_root, hparams, utterance_ids=ids)

    model = tacotron_model_factory(hparams)
    mesh = make_mesh(hparams.mesh_shape)
    state = Trainer(model, args.checkpoint_dir, device=device, mesh=mesh).restore_inference()
    batch_size = args.batch_size or hparams.batch_size
    world = mesh.size
    if world > 1 and batch_size % world == 0:
        predict = make_sharded_predict_fn(state.net, make_mesh((world, 1)), device=device)
    else:
        predict = make_predict_fn(state.net, device=device)
    chief = mesh.rank == 0
    batches = data.batches(
        batch_size, shuffle=False, repeat=False, drop_incomplete=False, prefetch=0
    )
    if chief:
        os.makedirs(args.output_dir, exist_ok=True)
        if hparams.use_forced_alignment_mode:
            with open(os.path.join(args.output_dir, "FORCED_ALIGNMENT_NOTE.txt"), "w") as f:
                f.write(FORCED_ALIGNMENT_NOTE)
        print(f"[predict_mel] step {state.step} of {args.checkpoint_dir} on {device} "
              f"({world} rank{'s' if world > 1 else ''}); images by {image_writer()}", flush=True)

    written: Dict[str, int] = {}
    synthesis_s = 0.0
    for index, batch in enumerate(batches):
        begin = time.perf_counter()
        feed = {"source": batch["source"], "source_lengths": batch["source_lengths"]}
        if hparams.use_accent_type:
            feed["accent_type"] = batch["accent_type"]
        if hparams.use_speaker_embedding:
            feed["speaker_id"] = batch["speaker_id"]
        if hparams.use_forced_alignment_mode:
            feed["target_lengths"] = batch["target_lengths"]
        out = predict(feed, step_generator(hparams.random_seed, index, device=device))
        # mel families predict "mel"; the WORLD heads "mgc" and "lf0" class logits,
        # written as float32 mgc and int32 argmax bins
        primary = "mel" if "mel" in out else "mgc"
        frames = out[primary].float().cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        lf0 = out["lf0"].float().cpu().numpy() if "lf0" in out else None
        linear = (out["linear"].float().cpu().numpy()
                  if audio is not None and "linear" in out else None)
        aligns = [a.float().cpu().numpy() for a in out["alignments"]]
        synthesis_s += time.perf_counter() - begin
        for i, utt_id in enumerate(batch["id"]):
            utt_id = str(utt_id)
            if utt_id in written:   # the padded tail of the last batch repeats ids
                continue
            n = int(lengths[i])
            written[utt_id] = n
            if not chief:
                continue
            predicted = frames[i, :n].astype(np.float32)
            if primary == "mel":
                predicted.tofile(os.path.join(
                    args.output_dir, f"{utt_id}.{hparams.predicted_mel_extension}"))
            else:
                predicted.tofile(os.path.join(args.output_dir, f"{utt_id}.mgc"))
                np.argmax(lf0[i, :n], axis=-1).astype(np.int32).tofile(
                    os.path.join(args.output_dir, f"{utt_id}.lf0"))
            save_alignment_png(
                [a[i] for a in aligns],
                os.path.join(args.output_dir, f"{utt_id}_alignment.png"),
                info=(f"{utt_id} (forced-align: reconstructed, unverified)"
                      if hparams.use_forced_alignment_mode else utt_id),
                source_length=int(batch["source_lengths"][i]),
                decoder_steps=max(n // hparams.outputs_per_step, 1),
            )
            save_mel_comparison_png(
                predicted,
                batch[primary][i][: batch["target_lengths"][i]] if primary in batch else None,
                os.path.join(args.output_dir, f"{utt_id}_mel.png"),
                info=utt_id,
            )
            if linear is not None:
                wav = audio.inv_spectrogram(linear[i, :n])
                audio.save_wav(wav, os.path.join(args.output_dir, f"{utt_id}.wav"))
            print(f"{utt_id}: {n} frames")
    if chief:
        print(f"wrote predictions to {args.output_dir}")
    return {"frames": written, "synthesis_s": synthesis_s}


if __name__ == "__main__":
    main()
