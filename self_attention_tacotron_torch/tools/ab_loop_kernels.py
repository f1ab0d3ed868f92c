"""Time one tree's loop kernels in their forward-attention instantiations, for an A/B
of two commits on one card.

    python3 self_attention_tacotron_torch/tools/ab_loop_kernels.py TREE LABEL

TREE is a checkout: this tree (``.``), or the parent commit's package unpacked
with ``git archive`` into the git-ignored ``runs/parent``. The script is run by
its path, so that the package it imports is TREE's: that tree builds its own
kernels into its own ``build/``, so both trees' kernels run in one process each,
on one card. It times by CUDA events, from seeded weights at full width (B=32,
S=128 ragged):

* ``fused_decode`` (whole-loop decode), 500 steps to the cap, prenet dropout
  from injected masks: every instantiation (the four pairs of ``dual`` /
  ``use_sa``, the two location-sensitive ones, the four with the lf0 feedback,
  each in float32 and bfloat16) at B=32 and B=1, the flagship also at B=128 and
  B=528 (labels ``_b1``, ``_b128``, ``_b528``); five launches each after a warm-up
  (three at B=128 and B=528);
* the teacher-forced decoder kernels (``fused_teacher``, forward and backward,
  N=400, train zoneout and prenet dropout): two sources (the flagship's widths)
  in float32 and bfloat16, one source (the baseline's) in float32; five launches
  each after a warm-up;
* the BiGRU backward's carry kernel (``bigru_bwd``, float32, H=128; five runs of
  20 launches),

and prints one ``AB {...}`` JSON line with the card's name and power limit and
the median of each; with ``--decode`` after LABEL, the decode kernels only. Run it
in turns (parent, change, change, parent) in one chip call:

    for t in runs/parent:parent .:change .:change runs/parent:parent; do
      python3 self_attention_tacotron_torch/tools/ab_loop_kernels.py "${t%%:*}" "${t##*:}"
    done

Needs a CUDA device; the tree must have ``self_attention_tacotron_torch/ops``.
"""
import json
import os
import subprocess
import sys

import numpy as np

B, S, N, T = 32, 128, 400, 500


def _events_ms(fn, runs: int = 6, inner: int = 1):
    """Device time of ``inner`` calls of ``fn``, ``runs - 1`` times after a warm-up."""
    import torch

    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end) / inner)
    return times


def _decode_cases():
    """(label, hparams overrides, batches) of every instantiation of the decode kernel:
    the four pairs of ``dual`` / ``use_sa`` (mel head, forward attention), the two
    location-sensitive ones and the four with the lf0 feedback (WORLD heads), each in
    float32 and bfloat16, at B=32 and B=1; the flagship also at B=128 and B=528."""
    pairs = (
        ("dual_sa", dict(decoder="DualSourceSelfAttentionDecoder", attention2="additive")),
        ("dual", dict(decoder="DualSourceDecoder", attention2="additive")),
        ("single", dict(decoder="ExtendedDecoder", encoder="EncoderV1")),
        ("sa", dict(decoder="SelfAttentionDecoder", encoder="EncoderV1")),
    )
    for pair, base in pairs:
        for branch in ("", "ls", "lf0"):
            if branch == "ls" and pair not in ("dual_sa", "single"):
                continue
            overrides = dict(base)
            if branch == "ls":
                overrides["attention"] = "location_sensitive"
            if branch == "lf0":
                overrides["decoder"] = "MgcLf0" + base["decoder"]
            for io in ("f32", "bf16"):
                label = f"decode_{pair}{'_' + branch if branch else ''}_{io}"
                batches = (32, 1, 128, 528) if pair == "dual_sa" and not branch else (32, 1)
                dtype = dict(compute_dtype="bfloat16") if io == "bf16" else {}
                yield label, dict(overrides, **dtype), batches


def _decode_times(dev, rng):
    import torch
    from self_attention_tacotron_torch.hparams import HParams
    from self_attention_tacotron_torch.models.decoders import DecoderConditioning
    from self_attention_tacotron_torch.models.models import TacotronNetwork
    from self_attention_tacotron_torch.ops import fused_decode

    out = {}
    for label, overrides, batches in _decode_cases():
        torch.manual_seed(3)
        hp = HParams(attention="forward", num_symbols=256, max_iters=T)
        hp = hp.override_from_dict(overrides)
        decoder = TacotronNetwork(hp).decoder.to(dev).eval()
        packed = fused_decode.pack_decoder(decoder)
        for batch in batches:
            lengths = np.clip(rng.integers(24, 129, batch), 24, 128)
            lengths[0] = 128
            memories = tuple(
                torch.tensor(rng.standard_normal((batch, S, e)).astype(np.float32), device=dev)
                for e in decoder.memory_units)
            mask = (torch.arange(S, device=dev)[None, :]
                    < torch.tensor(lengths, device=dev)[:, None])
            with torch.no_grad():
                cond = DecoderConditioning(memories=memories, keys=decoder.compute_keys(memories),
                                           masks=tuple(mask for _ in memories))
            masks = tuple(torch.tensor(rng.random((T, batch, u)) < 0.5, device=dev)
                          for u in hp.decoder_prenet_out_units)
            name = label if batch == B else f"{label}_b{batch}"
            out[name] = _events_ms(lambda: fused_decode.fused_decode(
                packed, cond, masks, T, 2.0, early_exit=False), runs=6 if batch <= B else 4)
    return out


def _teacher_times(dev, rng):
    import torch
    from self_attention_tacotron_torch.ops import fused_teacher

    def arr(*shape, scale=0.3):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * np.float32(scale),
                            device=dev)

    fan = lambda k: 1.0 / np.sqrt(k)  # noqa: E731
    out = {}
    for label, dual, io in (("teacher_dual_f32", True, "float32"),
                            ("teacher_dual_bf16", True, "bfloat16"),
                            ("teacher_single_f32", False, "float32")):
        z = dict(F=80, P1=256, P2=128, AU=256, A1=224, A2=32 if dual else 0, DU=256, E1=256,
                 E2=256 if dual else 0)
        A, E = z["A1"] + z["A2"], z["E1"] + z["E2"]
        in_att, in1 = z["P2"] + E + z["AU"], z["AU"] + E + z["DU"]
        vblk = torch.zeros(A, 2 if dual else 1, device=dev)
        vblk[: z["A1"], 0] = arr(z["A1"])
        if dual:
            vblk[z["A1"]:, 1] = arr(z["A2"])
        w = dict(
            w_p1=arr(z["F"], z["P1"]), b_p1=arr(z["P1"]),
            w_p2=arr(z["P1"], z["P2"], scale=fan(z["P1"])), b_p2=arr(z["P2"]),
            w_attg=arr(in_att, 4 * z["AU"], scale=fan(in_att)), b_attg=arr(4 * z["AU"]),
            w_qp=arr(z["AU"], A, scale=fan(z["AU"])), vblk=vblk,
            w_ta=arr(z["E1"] + z["AU"], 1, scale=fan(z["AU"])), b_ta=arr(1),
            w_l1=arr(in1, 4 * z["DU"], scale=fan(in1)), b_l1=arr(4 * z["DU"]),
            w_l2=arr(2 * z["DU"], 4 * z["DU"], scale=fan(2 * z["DU"])), b_l2=arr(4 * z["DU"]),
        )
        lengths = np.clip(rng.integers(24, 129, B), 24, 128)
        lengths[0] = 128
        lens = torch.tensor(lengths, device=dev)
        cast = torch.bfloat16 if io == "bfloat16" else torch.float32
        ops = dict(
            keys=arr(B, S, A).to(cast), mem1=arr(B, S, z["E1"]).to(cast),
            mem2=arr(B, S, z["E2"]).to(cast) if dual else None, spk=None,
            score_bias=torch.where(torch.arange(S, device=dev)[None] < lens[:, None],
                                   0.0, -1e9).float(),
            hp_like=dict(dual=dual, use_ta=False, att_units=z["AU"], att1_units=z["A1"],
                         att2_units=z["A2"], dec_units=z["DU"], zoneout_cell=0.1,
                         zoneout_output=0.1, prenet_drop_rate=0.5, io_dtype=io,
                         src1_kind="forward", eval_zoneout=False),
        )
        feeds = arr(B, N, z["F"])
        masks = tuple(torch.tensor(rng.random((B, N, u)) < 0.5, device=dev)
                      for u in (z["P1"], z["P2"]))
        cot = arr(B, N, z["DU"], scale=1.0)
        fwd, bwd = [], []
        for i in range(6):
            wl = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
            feat, _ = fused_teacher.teacher_decode(weights=wl, feeds=feeds, seed=1234,
                                                   prenet_masks=masks, **ops)
            (feat * cot).sum().backward()
            if i:
                fwd.append(fused_teacher.last_launch_ms("fwd"))
                bwd.append(fused_teacher.last_launch_ms("bwd"))
        out[f"{label}_fwd"], out[f"{label}_bwd"] = fwd, bwd
    return out


def _bigru_bwd_times(dev, rng):
    import torch
    from self_attention_tacotron_torch.ops import fused_rnn

    def arr(*shape, scale=0.3):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * np.float32(scale),
                            device=dev)

    C = H = 128
    fan = 1.0 / np.sqrt(C + H)
    lengths = np.clip(rng.integers(24, 129, B), 24, 128)
    lengths[0] = 128
    lens = torch.tensor(lengths, device=dev)
    xs = arr(B, S, C, scale=1.0)
    params = [{"gates_kernel": arr(C + H, 2 * H, scale=fan), "gates_bias": arr(2 * H, scale=0.1),
               "candidate_kernel": arr(C + H, H, scale=fan), "candidate_bias": arr(H, scale=0.1)}
              for _ in range(2)]
    weights = [p[k] for p in params for k in fused_rnn._PARAM_KEYS]
    y = fused_rnn.bigru(xs, lens, params[0], params[1], H)
    rz, n, hp, _, _, wgh_t, wch_t = fused_rnn.bwd_operands(xs, y, weights, H)
    g_y = arr(B, S, 2 * H, scale=1.0)
    return {"bigru_bwd": _events_ms(
        lambda: fused_rnn.bigru_bwd_carry(g_y, rz, n, hp, lens, wgh_t, wch_t), inner=20)}


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    tree, label = os.path.abspath(args[0]), args[1]
    sys.path.insert(0, tree)
    import torch
    from self_attention_tacotron_torch.ops import fused_teacher

    assert fused_teacher.__file__.startswith(tree), fused_teacher.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    times = {}
    times.update(_decode_times(dev, np.random.default_rng(4)))
    if "--decode" not in args[2:]:
        times.update(_teacher_times(dev, np.random.default_rng(5)))
        times.update(_bigru_bwd_times(dev, np.random.default_rng(6)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("AB " + json.dumps({"tree": label, "card": card, "ms": times,
                              "median": {k: float(np.median(v)) for k, v in times.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
