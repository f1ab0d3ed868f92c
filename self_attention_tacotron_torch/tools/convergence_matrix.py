"""The convergence matrix of the port: each conditioned family learns its conditioning.

``python -m self_attention_tacotron_torch.tools.convergence_matrix``: the port's
counterpart of ``scripts/convergence_matrix.py``, with its flags, families and
``ok`` predicates. Each family trains from weights drawn from ``random_seed`` on a
variant of the synthetic corpus through the port's ``train`` command line (in this
process; a run directory whose checkpoint already covers ``--steps`` is scored
without training), then synthesizes from its latest checkpoint and shows that the
conditioning shapes the output:

* ``speaker`` (the VCTK configuration on four synthetic speakers, each a register
  1.35x higher): the same text under each speaker id gives mel centroids in the
  speakers' order that track the training statistics over at least 60 % of their
  range;
* ``accent`` (pitch-accent types; odd types double the fundamental): all-high accent
  sequences raise the centroid over all-low ones by more than half a bin;
* ``mgclf0`` (the WORLD-feature heads with ``ZoneoutEncoderV1``): held-out lf0 frame
  accuracy beats the majority class by 0.1, and both head losses fall;
* ``ls`` (location-sensitive attention on the single-source ``ExtendedDecoder``, on a
  harder corpus of 1024 utterances of 48-64 symbols): the median diagonality of the
  alignments above 0.8;
* ``postnet`` (the linear-spectrogram PostCBHG): the linear loss falls, the held-out
  spectrogram beats a mean-spectrum predictor twice over, and Griffin-Lim (the port's
  ``audio/``) gives a finite waveform.

Every family's loss must fall too. Each predicate is a function of the result dict
alone (``OK``), so that it can be fed another run's recorded numbers.

``matrix.json`` in ``--out-dir`` is merged per family, so that families can run in
separate invocations (for instance ``--families speaker --steps 5000``, then the
others at 2500), with one greyscale PNG per family beside it; checkpoints stay under
``--run-root``. Each entry's ``provenance`` names the card and its power limit and
reads the training and decode paths from the kernels' launch counters.

It runs on the card; ``--device cpu`` runs it on the CPU. Nothing falls back.

Usage:
  python -m self_attention_tacotron_torch.tools.convergence_matrix \\
      [--families speaker,accent,mgclf0,ls,postnet] [--steps 1500] \\
      [--hparams-extra k=v,...] [--run-root runs/matrix] [--out-dir artifacts/convergence_h100] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from self_attention_tacotron_torch.hparams import HParams, default_hparams
from self_attention_tacotron_torch.tools import convergence_run as run_lib
from self_attention_tacotron_torch.tools.convergence_run import (
    device_of,
    launch_counts,
    line_plot_png,
    parse_extra,
    read_metrics,
    reset_launch_counts,
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# --hparams-extra: merged last into every family's hparams, training and scoring
EXTRA: Dict[str, str] = {}

COMMON = dict(
    dataset="synthetic",
    compute_dtype="bfloat16",
    use_gradient_clipping="true",
    use_cache="true",
    save_summary_steps="50",
    log_step_count_steps="50",
    save_checkpoints_steps="1000",
    alignment_save_steps="500",
    eval_start_delay_secs="999999",   # short runs: no evaluation mid-run
    batch_size="32",
)

FLAGSHIP = dict(
    tacotron_model="DualSourceSelfAttentionTacotronModel",
    encoder="SelfAttentionCBHGEncoder",
    decoder="DualSourceSelfAttentionDecoder",
    attention="forward",
    attention2="additive",
)

# generate_corpus's arguments: every family's default, and each family's own over it
# (the ls family's corpus is harder: longer and more utterances)
CORPUS = dict(num_utterances=192, min_symbols=17, max_symbols=24)
FAMILY_CORPUS = dict(
    speaker=dict(num_speakers=4), accent=dict(with_accent=True), mgclf0={},
    ls=dict(num_utterances=1024, min_symbols=48, max_symbols=64), postnet={},
)
# the validation utterances each family synthesizes
VAL_UTTERANCES = 8


def hp_obj(overrides: Dict[str, object]) -> HParams:
    hp = default_hparams()
    hp.parse(",".join(f"{k}={v}" for k, v in overrides.items()))
    return hp


# --------------------------------------------------------------------------- #
# Training and scoring, shared by the families
# --------------------------------------------------------------------------- #


def run_train(tag: str, run_root: str, overrides: Dict[str, object], steps: int,
              device: str) -> dict:
    """Generate the family's corpus variant (``FAMILY_CORPUS[tag]`` over ``CORPUS``)
    and train it through the ``train`` command
    line up to ``steps``; returns the paths, the hparams, the logged losses and the
    training's launch counts (None where the checkpoint already covered ``steps``)."""
    from self_attention_tacotron_torch import train
    from self_attention_tacotron_torch.data.synthetic import generate_corpus
    from self_attention_tacotron_torch.training.trainer import CheckpointManager

    run_dir = os.path.join(run_root, tag)
    data_dir, list_dir = os.path.join(run_dir, "data"), os.path.join(run_dir, "lists")
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    # a run shorter than the cadences still logs a loss trajectory
    overrides = dict(
        overrides,
        save_summary_steps=str(min(int(overrides["save_summary_steps"]), steps)),
        log_step_count_steps=str(min(int(overrides["log_step_count_steps"]), steps)),
        **EXTRA,
    )
    hp = hp_obj(overrides)
    gen_kw = dict(CORPUS, **FAMILY_CORPUS[tag])
    # a run directory whose corpus was generated with other arguments is stale:
    # wipe it and generate again rather than train on the old data and checkpoints
    meta_path = os.path.join(run_dir, "corpus_meta.json")
    if os.path.exists(os.path.join(list_dir, "train.lst")):
        old = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                old = json.load(f)
        if old != gen_kw:
            print(f"[matrix] {tag}: corpus params changed ({old} -> {gen_kw}); "
                  f"wiping {run_dir}", flush=True)
            shutil.rmtree(run_dir)
    seconds = {}
    if not os.path.exists(os.path.join(list_dir, "train.lst")):
        begin = time.perf_counter()
        generate_corpus(data_dir, hp, **gen_kw, selected_list_dir=list_dir, device=device)
        seconds["generate"] = time.perf_counter() - begin
        os.makedirs(run_dir, exist_ok=True)
        with open(meta_path, "w") as f:
            json.dump(gen_kw, f)
    # idempotent: the train command line counts --steps from the restored step, so a
    # finished run is scored again without training
    done = CheckpointManager(ckpt_dir).latest_step() or 0
    training = None
    if done < steps:
        reset_launch_counts()
        begin = time.perf_counter()
        train.main([
            f"--source-data-root={data_dir}", f"--checkpoint-dir={ckpt_dir}",
            f"--selected-list-dir={list_dir}", "--selected-list-filename=train",
            "--validation-list-filename=validation", f"--steps={steps - done}",
            "--hparams=" + ",".join(f"{k}={v}" for k, v in overrides.items()),
        ])
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        seconds["train"] = time.perf_counter() - begin
        seconds["steps_trained"] = steps - done
        training = launch_counts()
    else:
        print(f"[matrix] {tag}: checkpoint at step {done} >= {steps}; "
              "re-scoring without retraining", flush=True)
    losses = [(rec["step"], rec) for rec in read_metrics(os.path.join(ckpt_dir, "log"))
              if "loss" in rec]
    return dict(run_dir=run_dir, data_dir=data_dir, list_dir=list_dir, ckpt_dir=ckpt_dir,
                losses=losses, hp=hp, training=training, seconds=seconds, device=device)


def restore_network(info: dict):
    """The latest checkpoint's network (eval mode) and its step."""
    from self_attention_tacotron_torch.models.models import tacotron_model_factory
    from self_attention_tacotron_torch.training.trainer import Trainer

    trainer = Trainer(tacotron_model_factory(info["hp"]), info["ckpt_dir"], device=info["device"])
    state = trainer.restore_inference()
    return state.net.eval(), int(state.step)


def load_val_batch(info: dict, n: int = VAL_UTTERANCES, with_accent: bool = False):
    """The first ``n`` validation utterances as a padded request (numpy arrays)."""
    from self_attention_tacotron_torch.data.dataset import (
        parse_source_tfrecord,
        parse_target_tfrecord,
        read_selected_list,
    )

    hp = info["hp"]
    ids = read_selected_list(info["list_dir"], "validation")[:n]
    srcs = [parse_source_tfrecord(os.path.join(info["data_dir"], f"{u}.{hp.source_file_extension}"))
            for u in ids]
    tgts = [parse_target_tfrecord(os.path.join(info["data_dir"], f"{u}.{hp.target_file_extension}"))
            for u in ids]
    S = max(len(s.source) for s in srcs)
    batch = {
        "source": np.stack([np.pad(s.source, (0, S - len(s.source))) for s in srcs]).astype(np.int64),
        "source_lengths": np.asarray([len(s.source) for s in srcs], np.int64),
    }
    if getattr(srcs[0], "speaker_id", None) is not None:
        batch["speaker_id"] = np.asarray([s.speaker_id for s in srcs], np.int64)
    if with_accent:
        batch["accent_type"] = np.stack([
            np.pad(s.accent_type, (0, S - len(s.accent_type))) for s in srcs]).astype(np.int64)
    return ids, srcs, tgts, batch


def synthesize(info: dict, net, batch: dict) -> dict:
    """One request through ``make_predict_fn`` (the card's kernels where the
    configuration has them), the prenet's draws from a generator seeded 0; outputs as
    float32 numpy arrays and the request's launch counts under ``"launches"``."""
    from self_attention_tacotron_torch.synthesis import make_predict_fn

    device = info["device"]
    predict = make_predict_fn(net, device=device)
    reset_launch_counts()
    out = predict(batch, torch.Generator(device=device).manual_seed(0))
    result = {k: ([a.float().cpu().numpy() for a in v] if isinstance(v, (list, tuple))
                  else v.float().cpu().numpy() if torch.is_tensor(v) and v.is_floating_point()
                  else v.cpu().numpy() if torch.is_tensor(v) else v)
              for k, v in out.items()}
    result["launches"] = launch_counts()
    return result


def mel_centroid(mel: np.ndarray) -> float:
    """Energy-weighted mean mel-bin index: the register statistic."""
    w = np.maximum(mel - mel.min(), 0.0) ** 2
    bins = np.arange(mel.shape[-1], dtype=np.float64)
    denom = w.sum() + 1e-9
    return float((w * bins[None, :]).sum() / denom)


def diagonality(align: np.ndarray, src_len: int, dec_len: int) -> float:
    """Fraction of alignment mass within +-0.15 S of the monotone diagonal."""
    a = align[:dec_len, :src_len]
    s_pos = np.arange(src_len)[None, :]
    centers = np.linspace(0, src_len - 1, dec_len)[:, None]
    band = np.abs(s_pos - centers) <= max(0.15 * src_len, 2.0)
    return float((a * band).sum() / (a.sum() + 1e-9))


def panels_png(panels: Sequence[np.ndarray], out_png: str, side_by_side: bool = False) -> None:
    """Matrices as one greyscale PNG (``training/metrics.py``'s panels), stacked top to
    bottom in the order given, or side by side, three white lines between panels; the
    titles go to the family's entry of ``matrix.json``, since the PNG has no text."""
    from self_attention_tacotron_torch.training.metrics import panel_image, write_grey_png

    images = [panel_image(np.asarray(p, np.float32)) for p in panels]
    size = max(im.shape[0 if side_by_side else 1] for im in images)
    parts = []
    for im in images:
        if side_by_side:
            parts += [np.pad(im, ((size - im.shape[0], 0), (0, 0))),
                      np.full((size, 3), 255, np.uint8)]
        else:
            parts += [np.pad(im, ((0, 0), (0, size - im.shape[1]))),
                      np.full((3, size), 255, np.uint8)]
    write_grey_png(out_png, np.concatenate(parts[:-1], axis=1 if side_by_side else 0))


def _first_last(info: dict, key: str = "loss"):
    recs = [r for _, r in info["losses"] if key in r]
    return recs[0][key], recs[-1][key]


# --------------------------------------------------------------------------- #
# The predicates: each a function of a family's result dict alone
# --------------------------------------------------------------------------- #


def speaker_ok(r: dict) -> bool:
    return bool(r["register_order_monotonic"] and r["centroid_correlation"] > 0.9
                and r["centroid_range_ratio"] >= 0.6 and r["final_loss"] < r["first_loss"])


def accent_ok(r: dict) -> bool:
    return bool(r["centroid_all_high"] > r["centroid_all_low"] + 0.5
                and r["final_loss"] < r["first_loss"])


def mgclf0_ok(r: dict) -> bool:
    return bool(r["heldout_lf0_frame_accuracy"] > r["lf0_majority_baseline"] + 0.1
                and r["final_mgc_loss"] < r["first_mgc_loss"]
                and r["final_lf0_loss"] < r["first_lf0_loss"])


def ls_ok(r: dict) -> bool:
    return bool(r["median_diagonality"] > 0.8 and r["final_loss"] < r["first_loss"])


def postnet_ok(r: dict) -> bool:
    return bool(r["final_linear_loss"] < r["first_linear_loss"]
                and r["heldout_spec_mse"] < 0.5 * r["mean_predictor_spec_mse"]
                and r["griffin_lim_wav_finite"])


OK: Dict[str, Callable[[dict], bool]] = dict(
    speaker=speaker_ok, accent=accent_ok, mgclf0=mgclf0_ok, ls=ls_ok, postnet=postnet_ok)


def _entry(family: str, steps: int, step: int, info: dict, launches: Dict[str, int],
           **numbers) -> dict:
    """A family's result: its numbers, the provenance of its training and synthesis
    (``launches``: the synthesis's launch counts), and ``ok``."""
    first, last = _first_last(info)
    prov = run_lib.provenance(info["hp"], info["device"], info["training"], launches, EXTRA)
    result = dict(family=family, steps=steps, checkpoint_step=step, provenance=prov,
                  first_loss=first, final_loss=last, **numbers)
    result["seconds"] = info["seconds"]
    result["ok"] = OK[family](result)
    return result


# --------------------------------------------------------------------------- #
# The families
# --------------------------------------------------------------------------- #


def family_speaker(run_root: str, out_dir: str, steps: int, device: str) -> dict:
    """Multi-speaker (VCTK configuration): a speaker swap moves the register."""
    overrides = dict(COMMON, **FLAGSHIP, use_speaker_embedding="true", num_speakers="4",
                     speaker_embedding_dim="16")
    info = run_train("speaker", run_root, overrides, steps, device)
    net, step = restore_network(info)
    ids, srcs, tgts, batch = load_val_batch(info)
    spk_stats: Dict[int, List[float]] = {}
    for s, t in zip(srcs, tgts):
        spk_stats.setdefault(int(s.speaker_id), []).append(mel_centroid(t.mel))
    true_cent = {k: float(np.mean(v)) for k, v in sorted(spk_stats.items())}
    pred_cent, mels, titles, launches = {}, [], [], None
    for spk in range(4):
        out = synthesize(info, net, dict(batch, speaker_id=np.full_like(batch["speaker_id"], spk)))
        launches = out["launches"] if launches is None else launches
        cents = [mel_centroid(out["mel"][i, : int(out["lengths"][i])])
                 for i in range(len(ids)) if int(out["lengths"][i]) >= 4]
        pred_cent[spk] = float(np.mean(cents)) if cents else float("nan")
        n = int(out["lengths"][0])
        mels.append(out["mel"][0, : max(n, 4)])
        titles.append(f"speaker {spk}: centroid {pred_cent[spk]:.2f} "
                      f"(train stat {true_cent.get(spk, float('nan')):.2f})")
    panels_png(mels, os.path.join(out_dir, "speaker_swap.png"))
    order_ok = all(pred_cent[k + 1] > pred_cent[k] for k in range(3))
    # the sampled validation utterances need not cover every speaker: correlate over
    # the speakers with a training statistic, three at least
    common = [k for k in sorted(pred_cent) if k in true_cent and np.isfinite(pred_cent[k])]
    corr = (float(np.corrcoef([pred_cent[k] for k in common],
                              [true_cent[k] for k in common])[0, 1])
            if len(common) >= 3 else float("nan"))
    pred_vals, true_vals = [pred_cent[k] for k in common], [true_cent[k] for k in common]
    range_ratio = ((max(pred_vals) - min(pred_vals)) / (max(true_vals) - min(true_vals))
                   if len(common) >= 2 and max(true_vals) > min(true_vals) else float("nan"))
    return _entry("speaker", steps, step, info, launches,
                  predicted_centroid_by_speaker=pred_cent, training_centroid_by_speaker=true_cent,
                  register_order_monotonic=bool(order_ok), centroid_correlation=corr,
                  centroid_range_ratio=range_ratio, png_titles=titles)


def family_accent(run_root: str, out_dir: str, steps: int, device: str) -> dict:
    """Pitch-accent conditioning: high-accent sequences raise the register."""
    overrides = dict(COMMON, **FLAGSHIP)
    overrides.update(encoder="SelfAttentionCBHGEncoderWithAccentType", use_accent_type="true",
                     num_accent_type="4", accent_type_offset="0",
                     accent_type_embedding_dim="8")
    info = run_train("accent", run_root, overrides, steps, device)
    net, step = restore_network(info)
    ids, srcs, tgts, batch = load_val_batch(info, with_accent=True)
    results, mels, titles, launches = {}, [], [], None
    # all-low (even type 0) against all-high (odd type 1) accents on the same phonemes
    for name, value in (("low", 0), ("high", 1)):
        out = synthesize(info, net, dict(batch, accent_type=np.full_like(batch["accent_type"], value)))
        launches = out["launches"] if launches is None else launches
        cents = [mel_centroid(out["mel"][i, : int(out["lengths"][i])])
                 for i in range(len(ids)) if int(out["lengths"][i]) >= 4]
        results[name] = float(np.mean(cents))
        n = int(out["lengths"][0])
        mels.append(out["mel"][0, : max(n, 4)])
        titles.append(f"all-{name} accents: centroid {results[name]:.2f}")
    panels_png(mels, os.path.join(out_dir, "accent_swap.png"))
    return _entry("accent", steps, step, info, launches,
                  centroid_all_low=results["low"], centroid_all_high=results["high"],
                  high_minus_low=results["high"] - results["low"], png_titles=titles)


def family_mgclf0(run_root: str, out_dir: str, steps: int, device: str) -> dict:
    """WORLD-feature family: the mgc regression and the lf0 classification learn."""
    overrides = dict(COMMON, tacotron_model="MgcLf0TacotronModel", encoder="ZoneoutEncoderV1",
                     decoder="MgcLf0ExtendedDecoder", attention="forward")
    info = run_train("mgclf0", run_root, overrides, steps, device)
    net, step = restore_network(info)
    ids, srcs, tgts, batch = load_val_batch(info)
    out = synthesize(info, net, batch)
    hp = info["hp"]
    accs, mses, stopped = [], [], []
    for i, t in enumerate(tgts):
        n = min(int(out["lengths"][i]), int(t.target_length))
        if n < 4:
            continue
        accs.append(float(np.mean(np.argmax(out["lf0"][i, :n], axis=-1) == t.lf0[:n])))
        mses.append(float(np.mean((out["mgc"][i, :n] - t.mgc[:n]) ** 2)))
        stopped.append(int(out["lengths"][i]) < hp.max_iters * hp.outputs_per_step)
    # the majority-class baseline of lf0 over the scored frames
    all_true = np.concatenate([t.lf0[: min(int(out["lengths"][i]), int(t.target_length))]
                               for i, t in enumerate(tgts)])
    majority = float(np.max(np.bincount(all_true.astype(np.int64))) / len(all_true))
    (first_mgc, last_mgc), (first_lf0, last_lf0) = (_first_last(info, "mgc_loss"),
                                                    _first_last(info, "lf0_loss"))
    acc = float(np.mean(accs)) if accs else float("nan")
    curves = [[(s, r[k]) for s, r in info["losses"] if k in r]
              for k in ("loss", "mgc_loss", "lf0_loss", "done_loss")]
    line_plot_png(os.path.join(out_dir, "mgclf0_losses.png"),
                  [tuple(zip(*c)) for c in curves if c])
    return _entry("mgclf0", steps, step, info, out["launches"],
                  first_mgc_loss=first_mgc, final_mgc_loss=last_mgc, first_lf0_loss=first_lf0,
                  final_lf0_loss=last_lf0, heldout_lf0_frame_accuracy=acc,
                  lf0_majority_baseline=majority,
                  heldout_mgc_mse=float(np.mean(mses)) if mses else float("nan"),
                  all_stopped=bool(all(stopped)),
                  png_title=f"MgcLf0: lf0 acc {acc:.2f} vs majority {majority:.2f} (step {step}); "
                            "loss, mgc_loss, lf0_loss, done_loss from black to light grey")


def family_ls(run_root: str, out_dir: str, steps: int, device: str) -> dict:
    """Location-sensitive attention trains through the LS teacher kernels on the
    single-source ``ExtendedDecoder``; a diagonal alignment should emerge.

    The corpus is harder than the other families': LS attention has no monotonic
    prior, and on 192 utterances of 17-24 symbols the decoder can identify an
    utterance from its first frames and replay it without reading the text."""
    overrides = dict(COMMON, tacotron_model="ExtendedTacotronV1Model", encoder="ZoneoutEncoderV1",
                     decoder="ExtendedDecoder", attention="location_sensitive")
    info = run_train("ls", run_root, overrides, steps, device)
    net, step = restore_network(info)
    ids, srcs, tgts, batch = load_val_batch(info)
    out = synthesize(info, net, batch)
    r = info["hp"].outputs_per_step
    diags, panels = [], []
    for i in range(len(ids)):
        n_dec = max(int(out["lengths"][i]) // r, 1)
        src = int(batch["source_lengths"][i])
        diags.append(diagonality(out["alignments"][0][i], src, n_dec))
        if i < 2:
            panels.append(out["alignments"][0][i][:n_dec, :src])
    panels_png(panels, os.path.join(out_dir, "ls_alignments.png"), side_by_side=True)
    return _entry("ls", steps, step, info, out["launches"],
                  median_diagonality=float(np.median(diags)),
                  diagonality_by_utterance=dict(zip(ids, diags)),
                  png_title=f"location-sensitive alignments of {ids[:2]} "
                            f"({run_lib.decode_path(out['launches'])}, step {step})")


def family_postnet(run_root: str, out_dir: str, steps: int, device: str) -> dict:
    """Linear-spectrogram PostCBHG: the linear loss falls, the held-out spectrogram
    tracks the truth, Griffin-Lim gives a finite waveform."""
    from self_attention_tacotron_torch.audio import Audio

    overrides = dict(COMMON, **FLAGSHIP, use_linear_spectrogram_postnet="true")
    info = run_train("postnet", run_root, overrides, steps, device)
    net, step = restore_network(info)
    ids, srcs, tgts, batch = load_val_batch(info)
    out = synthesize(info, net, batch)
    spec_mses, true_frames = [], []
    for i, t in enumerate(tgts):
        n = min(int(out["lengths"][i]), int(t.target_length))
        if n < 4 or t.spec is None:
            continue
        spec_mses.append(float(np.mean((out["linear"][i, :n] - t.spec[:n]) ** 2)))
        true_frames.append(t.spec[:n])
    # the skill floor: a text-blind predictor of the global mean spectrum of the
    # held-out frames
    allf = np.concatenate(true_frames) if true_frames else np.zeros((1, 1))
    mean_mse = float(np.mean((allf - allf.mean(0, keepdims=True)) ** 2))
    n0 = max(int(out["lengths"][0]), 4)
    wav = Audio(info["hp"], device=device).inv_spectrogram(out["linear"][0, :n0])
    wav_ok = bool(np.isfinite(wav).all() and float(np.abs(wav).max()) > 1e-4)
    first_lin, last_lin = _first_last(info, "linear_loss")
    n = min(int(out["lengths"][0]), int(tgts[0].target_length))
    panels_png([out["linear"][0, :n], tgts[0].spec[:n]], os.path.join(out_dir, "postnet_linear.png"))
    return _entry("postnet", steps, step, info, out["launches"], first_linear_loss=first_lin,
                  final_linear_loss=last_lin,
                  heldout_spec_mse=float(np.mean(spec_mses)) if spec_mses else float("nan"),
                  mean_predictor_spec_mse=mean_mse, griffin_lim_wav_finite=wav_ok,
                  png_title=f"{ids[0]}: predicted linear (top) and ground truth (step {step})")


FAMILIES = dict(speaker=family_speaker, accent=family_accent, mgclf0=family_mgclf0,
                ls=family_ls, postnet=family_postnet)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--families", default="speaker,accent,mgclf0,ls,postnet")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--hparams-extra", default="",
                   help="comma-separated k=v overrides merged last into every family")
    p.add_argument("--run-root", default=os.path.join(_REPO, "runs", "matrix"))
    p.add_argument("--out-dir", default=os.path.join(_REPO, "artifacts", "convergence_h100"))
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the CPU")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the command line ``argv``; 1 where a family's ``ok`` is false."""
    args = parse_args(argv)
    EXTRA.clear()
    EXTRA.update(parse_extra(args.hparams_extra))
    device = device_of(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    matrix_path = os.path.join(args.out_dir, "matrix.json")
    matrix = {}
    if os.path.exists(matrix_path):
        with open(matrix_path) as f:
            matrix = json.load(f)
    for fam in (f.strip() for f in args.families.split(",") if f.strip()):
        print(f"[matrix] === family: {fam} ===", flush=True)
        result = FAMILIES[fam](args.run_root, args.out_dir, args.steps, device)
        matrix[fam] = result
        with open(matrix_path + ".tmp", "w") as f:
            json.dump(matrix, f, indent=2)
        os.replace(matrix_path + ".tmp", matrix_path)
        print(f"[matrix] {fam}: ok={result['ok']} "
              + json.dumps({k: v for k, v in result.items() if isinstance(v, (int, float, bool))}),
              flush=True)
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
    bad = [k for k, v in matrix.items() if not v.get("ok")]
    print(f"[matrix] done; failing families: {bad or 'none'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
