"""The convergence run of the port: a corpus, training from scratch, synthesis, scores.

``python -m self_attention_tacotron_torch.tools.convergence_run``: the port's
counterpart of ``scripts/convergence_run.py``, with its flags. It trains the
flagship (``tools/flagship.py::FLAGSHIP_OVERRIDES``: the dual-source
Self-Attention Tacotron in bfloat16) from weights drawn from ``random_seed`` on the
synthetic corpus (whose per-symbol tones give a learnable alignment), synthesizes
the held-out validation set from the latest checkpoint with the real stop threshold
(0.5), and scores it: the loss curve (``metrics.jsonl`` -> ``loss_curve.png``),
predicted against true length per utterance, and the mel MSE over the overlapping
frames. Training and synthesis go through the port's command lines
(``train.main``, ``predict_mel.main`` with the argv a user would type), in this
process, so that the kernels' launch counters read what the run launched.

Everything lands in ``--run-dir``: the corpus, the checkpoints and logs, the
predictions, ``summary.json`` and ``trained_params.npz``, the latest checkpoint in
the flat layout of the JAX package's export (``params/...`` and ``batch_stats/...``
float32 arrays), which ``convert.load_npz``, the JAX package's ``load_variables_npz``
and ``bench.py --trained-npz`` read. The summary holds the npz's sha256 and size,
the run's wall seconds and steps per second, the card's name and power limit, and
the kernels' launches in training and in synthesis; with ``--score-draws N``, the
validation set's scores under N more draws of the prenet's dropout (which stays on
at inference), each from another seed.

It runs on the card; ``--device cpu`` runs it on the CPU. Nothing falls back.

Usage:
  python -m self_attention_tacotron_torch.tools.convergence_run --run-dir runs/convergence \\
      [--steps 8000] [--num-utterances 256] [--long] [--min-symbols N] [--max-symbols N] \\
      [--restore-from DIR] [--skip-train] [--skip-generate] [--hparams-extra k=v,...] \\
      [--score-draws N] [--device cpu]
  python -m self_attention_tacotron_torch.tools.convergence_run --spread RUN_DIR ...

``--spread`` reads finished runs instead: per run directory its seed, its validation
scores and the logged steps at which its loss more than tripled the median of the 20
logged steps before (``loss_jumps``), one JSON line each.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from self_attention_tacotron_torch.hparams import HParams, default_hparams
from self_attention_tacotron_torch.tools.flagship import FLAGSHIP_OVERRIDES, hparams_string

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# overrides merged last into every hparams of a run (--hparams-extra)
EXTRA: Dict[str, str] = {}


def parse_extra(text: str) -> Dict[str, str]:
    """``k=v,k=v`` -> dict (a tuple value takes ``+`` between its entries)."""
    return dict(kv.split("=", 1) for kv in text.split(",") if "=" in kv)


def hp_string(extra: Optional[Dict[str, object]] = None) -> str:
    return hparams_string({**FLAGSHIP_OVERRIDES, **EXTRA, **(extra or {})})


def flagship_run_hparams(extra: Optional[Dict[str, object]] = None) -> HParams:
    hp = default_hparams()
    hp.parse(hp_string(extra))
    return hp


def device_of(name: str) -> str:
    """``--device``: the card, or the CPU, where the command lines follow
    (``SATT_PLATFORM``)."""
    if name == "cpu":
        os.environ["SATT_PLATFORM"] = "cpu"
        return "cpu"
    os.environ.pop("SATT_PLATFORM", None)
    from self_attention_tacotron_torch.utils.platform import resolve_device

    return str(resolve_device("cuda"))


# --------------------------------------------------------------------------- #
# The corpus
# --------------------------------------------------------------------------- #


def generate(data_dir: str, list_dir: str, num_utterances: int, min_symbols: int = 17,
             max_symbols: int = 24, device="cuda") -> List[str]:
    """The synthetic corpus of the run (seed 1234) and its lists, and
    ``corpus_meta.json`` with the arguments."""
    from self_attention_tacotron_torch.data.synthetic import generate_corpus

    ids = generate_corpus(data_dir, flagship_run_hparams(), num_utterances=num_utterances,
                          min_symbols=min_symbols, max_symbols=max_symbols,
                          selected_list_dir=list_dir, device=device)
    with open(os.path.join(list_dir, "corpus_meta.json"), "w") as f:
        json.dump(dict(num_utterances=num_utterances, min_symbols=min_symbols,
                       max_symbols=max_symbols), f)
    print(f"[convergence] generated {len(ids)} utterances in {data_dir}", flush=True)
    return ids


def check_corpus_matches(list_dir: str, num_utterances: int, min_symbols: int,
                         max_symbols: int) -> None:
    """Refuse to reuse a corpus generated with other arguments (generation is skipped
    wherever ``train.lst`` exists, so ``--long`` in a run directory of the short corpus
    would otherwise train short utterances while calling itself the long run)."""
    meta_path = os.path.join(list_dir, "corpus_meta.json")
    want = dict(num_utterances=num_utterances, min_symbols=min_symbols, max_symbols=max_symbols)
    have = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            have = json.load(f)
    if have != want:
        raise SystemExit(
            f"[convergence] existing corpus in {list_dir} was generated with {have}, but "
            f"this invocation wants {want}; use a fresh --run-dir (or delete the corpus, or "
            "pass --skip-generate to reuse it) instead of training on mismatched data")


# --------------------------------------------------------------------------- #
# Launch counters and provenance
# --------------------------------------------------------------------------- #

# every kernel wrapper's launch counter: (module, attribute)
_COUNTERS = {
    "bigru": ("fused_rnn", "launch_count"),
    "bigru_proj": ("fused_rnn", "proj_launch_count"),
    "bigru_bwd": ("fused_rnn", "bwd_launch_count"),
    "bilstm": ("fused_rnn", "lstm_launch_count"),
    "bilstm_proj": ("fused_rnn", "lstm_proj_launch_count"),
    "mha_full": ("fused_attention", "launch_count"),
    "fused_decode": ("fused_decode", "launch_count"),
    "fused_teacher_fwd": ("fused_teacher", "launch_count"),
    "fused_teacher_bwd": ("fused_teacher", "bwd_launch_count"),
}


def _ops(name: str):
    import importlib

    return importlib.import_module(f"self_attention_tacotron_torch.ops.{name}")


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since the last ``reset_launch_counts``, with the decode
    and teacher kernels' launches per instantiation."""
    counts = {name: int(getattr(_ops(mod), attr)) for name, (mod, attr) in _COUNTERS.items()}
    for name in ("fused_decode", "fused_teacher"):
        counts[f"{name}_variants"] = {k if isinstance(k, str) else ",".join(map(str, k)): int(v)
                                      for k, v in _ops(name).variant_launches.items()}
    return counts


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(_ops(mod), attr, 0)
    _ops("fused_decode").variant_launches.clear()
    _ops("fused_teacher").variant_launches.clear()


def gpu_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them; None without a card or the tool."""
    if not torch.cuda.is_available():
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


DIMS = ("encoder_out_units", "cbhg_out_units", "attention_out_units", "attention1_out_units",
        "attention2_out_units", "decoder_out_units", "self_attention_out_units",
        "embedding_dim", "num_mels", "batch_size", "outputs_per_step")


def train_path(training: Optional[Dict[str, int]]) -> str:
    """How this run trained, read from the launch counters of its training."""
    if training is None:
        return "not trained in this invocation (restored from its checkpoint)"
    if training["fused_teacher_fwd"] > 0 and training["fused_teacher_bwd"] > 0:
        return "fused_teacher kernels"
    return "plain scan under autograd"


def decode_path(synthesis: Dict[str, int]) -> str:
    """How this run synthesized, read from the launch counters of its synthesis."""
    return "fused_decode kernel" if synthesis["fused_decode"] > 0 else "step-by-step loop"


def provenance(hp: HParams, device: str, training: Optional[Dict[str, int]],
               synthesis: Dict[str, int], extra: Optional[Dict[str, str]] = None) -> dict:
    """What produced the evidence: the device (the card's name and power limit), the
    decode and training paths from the launch counters, the widths, the overrides."""
    on_card = device.startswith("cuda")
    return dict(
        platform="gpu" if on_card else "cpu",
        device=torch.cuda.get_device_name(0) if on_card else "cpu",
        gpu=gpu_line() if on_card else None,
        torch=torch.__version__,
        decode_path=decode_path(synthesis),
        train_path=train_path(training),
        launches=dict(training=training, synthesis=synthesis),
        dims={k: getattr(hp, k) for k in DIMS},
        compute_dtype=hp.compute_dtype,
        random_seed=hp.random_seed,
        extra_overrides=dict(EXTRA if extra is None else extra),
    )


# --------------------------------------------------------------------------- #
# Plots without matplotlib: greyscale PNGs by the port's plain writer, on every machine
# --------------------------------------------------------------------------- #


def line_plot_png(path: str, series: Sequence[Tuple[Sequence[float], Sequence[float]]],
                  log_y: bool = True, size: Tuple[int, int] = (400, 720),
                  markers: Sequence[bool] = ()) -> None:
    """Draw each (xs, ys) of ``series`` as a polyline (the first black, the others in
    lighter greys; ``markers[i]`` marks its points instead) on a white frame with a
    shared x axis and a log y axis, as an 8-bit greyscale PNG."""
    from self_attention_tacotron_torch.training.metrics import write_grey_png

    height, width = size
    image = np.full((height, width), 255, np.uint8)
    pad = 12
    image[pad, pad:width - pad] = image[height - pad, pad:width - pad] = 0
    image[pad:height - pad, pad] = image[pad:height - pad, width - pad] = 0
    pts = [(np.asarray(x, np.float64), np.asarray(y, np.float64)) for x, y in series if len(x)]
    if not pts:
        write_grey_png(path, image)
        return
    xs = np.concatenate([x for x, _ in pts])
    ys = np.concatenate([y for _, y in pts])
    if log_y:
        ys = np.log10(np.maximum(ys, 1e-12))
    x0, y0 = float(xs.min()), float(ys.min())
    x1, y1 = max(float(xs.max()), x0 + 1.0), max(float(ys.max()), y0 + 1e-6)

    def to_pixels(x, y):
        y = np.log10(np.maximum(y, 1e-12)) if log_y else y
        col = pad + 2 + (x - x0) / (x1 - x0) * (width - 2 * pad - 4)
        row = height - pad - 2 - (y - y0) / (y1 - y0) * (height - 2 * pad - 4)
        return np.round(row).astype(int), np.round(col).astype(int)

    for i, (x, y) in enumerate(pts):
        level = min(60 * i, 180)
        rows, cols = to_pixels(x, y)
        if i < len(markers) and markers[i]:
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    image[rows + dr, cols + dc] = level
            continue
        for k in range(len(rows) - 1):
            n = max(abs(rows[k + 1] - rows[k]), abs(cols[k + 1] - cols[k])) + 1
            image[np.round(np.linspace(rows[k], rows[k + 1], n)).astype(int),
                  np.round(np.linspace(cols[k], cols[k + 1], n)).astype(int)] = level
        if len(rows) == 1:
            image[rows, cols] = level
    write_grey_png(path, image)


def read_metrics(log_dir: str) -> List[dict]:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def loss_jumps(records: List[dict], window: int = 20, factor: float = 3.0) -> List[int]:
    """The logged steps whose training loss is over ``factor`` times the median of the
    ``window`` logged steps before it."""
    rows = [(r["step"], r["loss"]) for r in records if "loss" in r]
    return [step for i, (step, loss) in enumerate(rows) if i >= window
            and loss > factor * float(np.median([v for _, v in rows[i - window:i]]))]


def spread(run_dirs: Sequence[str]) -> List[dict]:
    """Per run directory: its seed, its validation scores (``summary.json``) and the
    steps at which its loss jumped (``loss_jumps`` over ``metrics.jsonl``)."""
    rows = []
    for run_dir in run_dirs:
        with open(os.path.join(run_dir, "summary.json")) as f:
            summary = json.load(f)
        records = read_metrics(os.path.join(run_dir, "checkpoints", "log"))
        syn = summary["synthesis"]
        rows.append(dict(
            run_dir=repo_path(run_dir), random_seed=summary["provenance"]["random_seed"],
            steps=summary["steps"], logged_steps=sum("loss" in r for r in records),
            loss_jumps=loss_jumps(records), npz_sha256=summary["npz"]["sha256"],
            gpu=summary["provenance"]["gpu"], train_path=summary["provenance"]["train_path"],
            **{k: syn[k] for k in ("median_mel_mse", "mean_mel_mse",
                                   "median_abs_length_error_frames",
                                   "max_abs_length_error_frames", "all_stopped_before_cap")}))
    return rows


def plot_loss_curve(log_dir: str, out_png: str) -> dict:
    """The training loss, ``mel_loss`` and ``done_loss`` (lines) and ``eval_loss``
    (points) of ``metrics.jsonl`` on a log scale; returns the JAX run's loss summary."""
    steps, losses, extras = [], [], {}
    eval_steps, eval_losses = [], []
    for rec in read_metrics(log_dir):
        if "loss" in rec:
            steps.append(rec["step"])
            losses.append(rec["loss"])
            for k in ("mel_loss", "done_loss"):
                if k in rec:
                    extras.setdefault(k, ([], []))
                    extras[k][0].append(rec["step"])
                    extras[k][1].append(rec[k])
        if "eval_loss" in rec:
            eval_steps.append(rec["step"])
            eval_losses.append(rec["eval_loss"])
    series = [(steps, losses), *extras.values(), (eval_steps, eval_losses)]
    line_plot_png(out_png, series, markers=[False] * (len(series) - 1) + [True])
    return {
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
        "min_loss": min(losses) if losses else None,
        "final_eval_loss": eval_losses[-1] if eval_losses else None,
        "logged_points": len(steps),
    }


# --------------------------------------------------------------------------- #
# The checkpoint as a flat npz, and the scores
# --------------------------------------------------------------------------- #


def export_params_npz(ckpt_dir: str, out_npz: str, hparams: HParams) -> int:
    """The latest checkpoint of ``ckpt_dir`` as the flat npz of the JAX package's
    ``export_params_npz``: ``params/...`` and ``batch_stats/...`` keys, float32 arrays
    (``convert.torch_to_flax_flat``), compressed. Returns the checkpoint's step."""
    from self_attention_tacotron_torch import convert
    from self_attention_tacotron_torch.models.models import tacotron_model_factory
    from self_attention_tacotron_torch.training.trainer import CheckpointManager

    checkpoints = CheckpointManager(ckpt_dir)
    step = checkpoints.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    net = tacotron_model_factory(hparams).network(device="cpu")
    net.load_state_dict(checkpoints.load(step, "cpu")["net"])
    arrays = {k: np.asarray(v, np.float32) for k, v in convert.torch_to_flax_flat(net).items()}
    np.savez_compressed(out_npz, **arrays)
    print(f"[convergence] exported step-{step} params -> {out_npz} "
          f"({os.path.getsize(out_npz) / 1e6:.1f} MB)", flush=True)
    return int(step)


def repo_path(path: str) -> str:
    """``path`` relative to the repository where it lies inside it."""
    path = os.path.abspath(path)
    return os.path.relpath(path, _REPO) if path.startswith(_REPO + os.sep) else path


def file_digest(path: str) -> Dict[str, object]:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return {"sha256": digest.hexdigest(), "bytes": os.path.getsize(path)}


def score_predictions(data_dir: str, list_dir: str, pred_dir: str,
                      hparams: Optional[HParams] = None) -> dict:
    """Predicted against true lengths and the mel MSE over the overlap, per held-out
    utterance (``scripts/convergence_run.py::score_predictions``)."""
    from self_attention_tacotron_torch.data.dataset import (
        parse_target_tfrecord,
        read_selected_list,
    )

    hp = hparams or flagship_run_hparams()
    rows = []
    for utt_id in read_selected_list(list_dir, "validation"):
        tgt = parse_target_tfrecord(os.path.join(data_dir, f"{utt_id}.{hp.target_file_extension}"))
        mfbsp = os.path.join(pred_dir, f"{utt_id}.{hp.predicted_mel_extension}")
        if not os.path.exists(mfbsp):
            continue
        pred = np.fromfile(mfbsp, np.float32).reshape(-1, hp.num_mels)
        true_len = int(tgt.target_length)
        n = min(len(pred), true_len)
        mse = float(np.mean((pred[:n] - tgt.mel[:n]) ** 2)) if n else float("nan")
        rows.append(dict(id=utt_id, true_frames=true_len, predicted_frames=int(len(pred)),
                         length_error=int(len(pred)) - true_len, mel_mse=mse))
    errs = np.asarray([abs(r["length_error"]) for r in rows], np.float64)
    mses = np.asarray([r["mel_mse"] for r in rows], np.float64)
    frame_cap = hp.max_iters * hp.outputs_per_step
    return dict(
        utterances=rows,
        n_scored=len(rows),
        median_abs_length_error_frames=float(np.median(errs)) if len(errs) else None,
        max_abs_length_error_frames=float(errs.max()) if len(errs) else None,
        all_stopped_before_cap=bool(all(r["predicted_frames"] < frame_cap for r in rows)),
        mean_mel_mse=float(np.nanmean(mses)) if len(mses) else None,
        median_mel_mse=float(np.nanmedian(mses)) if len(mses) else None,
    )


def logged_steps_per_sec(log_dir: str) -> Optional[float]:
    """The median of the training loop's own ``steps_per_sec`` records."""
    rates = [r["steps_per_sec"] for r in read_metrics(log_dir) if "steps_per_sec" in r]
    return float(np.median(rates[1:] or rates)) if rates else None


# --------------------------------------------------------------------------- #
# The run
# --------------------------------------------------------------------------- #


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run-dir", default=os.path.join(_REPO, "runs", "convergence"))
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--num-utterances", type=int, default=256)
    p.add_argument("--skip-train", action="store_true",
                   help="reuse an existing checkpoint; just synthesize and score")
    p.add_argument("--skip-generate", action="store_true")
    p.add_argument("--hparams-extra", default="",
                   help="extra comma-separated overrides (smoke testing)")
    p.add_argument("--long", action="store_true",
                   help="the long-utterance run: 94-152 symbols (about 600-1000 mel frames)")
    p.add_argument("--min-symbols", type=int, default=None)
    p.add_argument("--max-symbols", type=int, default=None)
    p.add_argument("--restore-from", default=None,
                   help="warm-start the parameters from another run's checkpoint dir "
                        "(fine-tuning, for instance from the short-utterance run)")
    p.add_argument("--score-draws", type=int, default=0,
                   help="synthesize and score the validation set this many times more, each "
                        "with the prenet's dropout drawn from another seed")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card (default) or the CPU")
    p.add_argument("--spread", nargs="+", default=None, metavar="RUN_DIR",
                   help="print the scores and loss jumps of these finished runs (``spread``) "
                        "instead of running")
    args = p.parse_args(argv)
    if args.long:
        args.min_symbols = 94 if args.min_symbols is None else args.min_symbols
        args.max_symbols = 152 if args.max_symbols is None else args.max_symbols
    args.min_symbols = args.min_symbols or 17
    args.max_symbols = args.max_symbols or 24
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the command line ``argv`` (default ``sys.argv[1:]``); returns the summary."""
    from self_attention_tacotron_torch import predict_mel, train

    args = parse_args(argv)
    if args.spread:
        rows = spread(args.spread)
        for row in rows:
            print(json.dumps(row))
        return {"spread": rows}
    EXTRA.clear()
    EXTRA.update(parse_extra(args.hparams_extra))
    device = device_of(args.device)
    run_dir = os.path.abspath(args.run_dir)
    data_dir, list_dir = os.path.join(run_dir, "data"), os.path.join(run_dir, "lists")
    ckpt_dir, pred_dir = os.path.join(run_dir, "checkpoints"), os.path.join(run_dir, "predictions")
    os.makedirs(run_dir, exist_ok=True)
    seconds: Dict[str, float] = {}

    begin = time.perf_counter()
    if not args.skip_generate and not os.path.exists(os.path.join(list_dir, "train.lst")):
        generate(data_dir, list_dir, args.num_utterances, args.min_symbols, args.max_symbols,
                 device=device)
    elif not args.skip_generate:
        check_corpus_matches(list_dir, args.num_utterances, args.min_symbols, args.max_symbols)
    seconds["generate"] = time.perf_counter() - begin

    training = None
    if not args.skip_train:
        os.makedirs(ckpt_dir, exist_ok=True)
        train_args = [
            f"--source-data-root={data_dir}", f"--checkpoint-dir={ckpt_dir}",
            f"--selected-list-dir={list_dir}", "--selected-list-filename=train",
            "--validation-list-filename=validation", f"--steps={args.steps}",
            f"--hparams={hp_string()}",
        ]
        if args.restore_from:
            train_args.append(f"--restore-from={os.path.abspath(args.restore_from)}")
        print("[convergence] train", " ".join(train_args), flush=True)
        reset_launch_counts()
        begin = time.perf_counter()
        train.main(train_args)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        seconds["train"] = time.perf_counter() - begin
        training = launch_counts()

    # the validation set from the trained checkpoint with the real stop threshold, so
    # that every lane's early exit runs
    def predict(out_dir: str, **extra):
        predict_args = [
            f"--source-data-root={data_dir}", f"--checkpoint-dir={ckpt_dir}",
            f"--output-dir={out_dir}", f"--selected-list-dir={list_dir}",
            "--test-list-filename=validation", "--batch-size=16",
            f"--hparams={hp_string(dict(stop_token_threshold='0.5', **extra))}",
        ]
        print("[convergence] predict_mel", " ".join(predict_args), flush=True)
        return predict_mel.main(predict_args)

    reset_launch_counts()
    begin = time.perf_counter()
    predicted = predict(pred_dir)
    seconds["predict"] = time.perf_counter() - begin
    synthesis = launch_counts()

    hp = flagship_run_hparams()
    # the same weights under other draws of the prenet's dropout (on at inference)
    draws = []
    for k in range(1, args.score_draws + 1):
        seed = hp.random_seed + k
        draw_dir = os.path.join(run_dir, f"predictions_draw{k}")
        predict(draw_dir, random_seed=seed)
        scores = score_predictions(data_dir, list_dir, draw_dir, hp)
        draws.append(dict(random_seed=seed, **{key: scores[key] for key in (
            "median_abs_length_error_frames", "max_abs_length_error_frames",
            "all_stopped_before_cap", "median_mel_mse", "mean_mel_mse")}))
    summary = dict(steps=args.steps, run_dir=run_dir)
    log_dir = os.path.join(ckpt_dir, "log")
    if os.path.exists(os.path.join(log_dir, "metrics.jsonl")):
        summary["loss"] = plot_loss_curve(log_dir, os.path.join(run_dir, "loss_curve.png"))
        summary["logged_steps_per_sec"] = logged_steps_per_sec(log_dir)
    summary["synthesis"] = score_predictions(data_dir, list_dir, pred_dir, hp)
    if draws:
        summary["synthesis_draws"] = draws
    npz = os.path.join(run_dir, "trained_params.npz")
    summary["checkpoint_step"] = export_params_npz(ckpt_dir, npz, hp)
    summary["npz"] = dict(path=repo_path(npz), **file_digest(npz))
    summary["corpus"] = dict(num_utterances=args.num_utterances, min_symbols=args.min_symbols,
                             max_symbols=args.max_symbols, seed=1234)
    summary["restored_from"] = args.restore_from
    summary["seconds"] = seconds
    if "train" in seconds:
        summary["steps_per_sec"] = args.steps / seconds["train"]
    summary["synthesis_seconds"] = predicted["synthesis_s"]
    summary["provenance"] = provenance(hp, device, training, synthesis)
    path = os.path.join(run_dir, "summary.json")
    with open(path + ".tmp", "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(path + ".tmp", path)
    print(json.dumps({k: v for k, v in summary.items() if k != "synthesis"}, indent=2))
    syn = {k: v for k, v in summary["synthesis"].items() if k != "utterances"}
    print("[convergence] synthesis:", json.dumps(syn, indent=2), flush=True)
    return summary


if __name__ == "__main__":
    main()
