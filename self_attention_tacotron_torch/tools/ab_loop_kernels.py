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
  ``use_sa``, each with forward and with location-sensitive attention, with the
  mel head and with the lf0 feedback, in float32 and bfloat16) at B=32 and B=1, the
  flagship also at B=128 and B=528 (labels ``_b1``, ``_b128``, ``_b528``), and
  the flagship with forward and with location-sensitive attention in float32 at
  B=32 over a source of ``LONG_S`` positions, longer than two tiles of the
  alignment stage (label ``_s1100``); five launches each after a warm-up (three
  at B=128 and B=528);
* the teacher-forced decoder kernels (``fused_teacher``, forward and backward,
  N=400, train zoneout and prenet dropout): all 16 instantiations (two sources at
  the flagship's widths or one, forward or location-sensitive attention, float32
  or bfloat16, each direction) at B=32 and B=1, the flagship's structure also at
  B=8, B=64 and B=128 (labels ``_b1`` ...); five launches each after a warm-up,
  and whether the launches on the same inputs gave the same features and
  gradients bit for bit (``bit_for_bit``), with a digest of those features and
  gradients (``digest``, SHA-256 of their bytes): two trees whose digests agree
  computed the same bits;
* the BiGRU backward's carry kernel (``bigru_bwd``, float32, H=128; five runs of
  20 launches);
* with ``--rnn``: the recurrent kernels alone (``RNN_CASES``, ``LSTM_CASES``),
  C=H=128 from seeded weights: ``bigru`` (the whole forward, input projection
  included) in float32 and bfloat16 at B=1 (S=97), B=32 (S=128 ragged), B=128,
  B=528 and B=1024 (ragged), and ``bigru_bwd`` in both io types at B=1 and B=32;
  ``bilstm`` (the whole ZoneoutLSTM, input projection included, zoneout 0.1) in
  both io types at the batches of ``bigru``; five runs of 20 launches (5 from
  B=528 on);
* with ``--mha``: ``mha_full`` alone (``MHA_CASES``), the flagship's D=256 and 2
  heads from seeded qkv, in float32 and bfloat16 at B=1 (T=97), B=32 (T=128
  ragged), B=128 and B=528 (ragged), and B=1 at T=3000 (ragged, under the 3246
  positions beyond which the old design could not launch); five runs of 20
  launches (5 from B=528 and at T=3000),

and prints one ``AB {...}`` JSON line with the card's name and power limit and
the median of each (a case draws its inputs from a seed of its own, and a decode
case the tree does not serve is left out, so that two trees compare like with
like); with ``--decode`` after LABEL, the decode kernels only, with ``--teacher``
the teacher kernels only, with ``--rnn`` the recurrent kernels only, with
``--mha`` the attention kernel only (flags combine). Run it in turns (parent,
change, change, parent) in one chip call:

    for t in runs/parent:parent .:change .:change runs/parent:parent; do
      python3 self_attention_tacotron_torch/tools/ab_loop_kernels.py "${t%%:*}" "${t##*:}"
    done

Needs a CUDA device; the tree must have ``self_attention_tacotron_torch/ops``.
"""
import json
import os
import subprocess
import sys
import zlib

import numpy as np

B, S, N, T = 32, 128, 400, 500
LONG_S = 1100


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
    """(label, hparams overrides, (batch, source length) pairs) of every
    instantiation of the decode kernel: the four pairs of ``dual`` / ``use_sa``, each
    with forward and with location-sensitive attention, with the mel head and with
    the lf0 feedback (WORLD heads), in float32 and bfloat16, at B=32 and B=1; the
    flagship also at B=128 and B=528, and in float32 over LONG_S positions."""
    pairs = (
        ("dual_sa", dict(decoder="DualSourceSelfAttentionDecoder", attention2="additive")),
        ("dual", dict(decoder="DualSourceDecoder", attention2="additive")),
        ("single", dict(decoder="ExtendedDecoder", encoder="EncoderV1")),
        ("sa", dict(decoder="SelfAttentionDecoder", encoder="EncoderV1")),
    )
    for pair, base in pairs:
        for branch in ("", "ls", "lf0", "ls_lf0"):
            overrides = dict(base)
            if "ls" in branch:
                overrides["attention"] = "location_sensitive"
            if "lf0" in branch:
                overrides["decoder"] = "MgcLf0" + base["decoder"]
            for io in ("f32", "bf16"):
                label = f"decode_{pair}{'_' + branch if branch else ''}_{io}"
                batches = [(B, S), (1, S)]
                if pair == "dual_sa" and not branch:
                    batches += [(128, S), (528, S)]
                if pair == "dual_sa" and branch in ("", "ls") and io == "f32":
                    batches.append((B, LONG_S))
                dtype = dict(compute_dtype="bfloat16") if io == "bf16" else {}
                yield label, dict(overrides, **dtype), batches


def _decode_times(dev):
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
        if not fused_decode.supports_fused_decode(hp):
            continue   # an instantiation the tree does not have
        # inputs of the case's own, whichever cases the tree has
        rng = np.random.default_rng(zlib.crc32(label.encode()))
        decoder = TacotronNetwork(hp).decoder.to(dev).eval()
        packed = fused_decode.pack_decoder(decoder)
        for batch, src in batches:
            lengths = np.clip(rng.integers(24, src + 1, batch), 24, src)
            lengths[0] = src
            memories = tuple(
                torch.tensor(rng.standard_normal((batch, src, e)).astype(np.float32), device=dev)
                for e in decoder.memory_units)
            mask = (torch.arange(src, device=dev)[None, :]
                    < torch.tensor(lengths, device=dev)[:, None])
            with torch.no_grad():
                cond = DecoderConditioning(memories=memories, keys=decoder.compute_keys(memories),
                                           masks=tuple(mask for _ in memories))
            masks = tuple(torch.tensor(rng.random((T, batch, u)) < 0.5, device=dev)
                          for u in hp.decoder_prenet_out_units)
            name = (label + (f"_b{batch}" if batch != B else "")
                    + (f"_s{src}" if src != S else ""))
            out[name] = _events_ms(lambda: fused_decode.fused_decode(
                packed, cond, masks, T, 2.0, early_exit=False), runs=6 if batch <= B else 4)
    return out


def _teacher_cases():
    """(label, two sources, location-sensitive, io type, batches) of every
    instantiation of the teacher kernels: two sources (the flagship's widths) or one
    (the same widths, no second mechanism), forward or location-sensitive attention
    (31 taps over the cumulative alignments), float32 or bfloat16, at B=32 and B=1;
    the flagship's structure also at B=8, B=64 and B=128."""
    for dual in (True, False):
        for ls in (False, True):
            for io in ("float32", "bfloat16"):
                label = (f"teacher_{'dual' if dual else 'single'}{'_ls' if ls else ''}_"
                         f"{'f32' if io == 'float32' else 'bf16'}")
                batches = (B, 1) + ((8, 64, 128) if dual and not ls else ())
                yield label, dual, ls, io, batches


def _teacher_times(dev):
    """Forward and backward kernel times of every case of ``_teacher_cases`` (N=400,
    train zoneout, prenet dropout; five launches each after a warm-up), for each
    whether the launches on the same inputs gave the same features and gradients bit
    for bit (``bit_for_bit``: the label, True or the names that differ), and the
    SHA-256 of the first launch's features and gradients (``digest``)."""
    import hashlib

    import torch
    from self_attention_tacotron_torch.ops import fused_teacher

    fan = lambda k: 1.0 / np.sqrt(k)  # noqa: E731
    out, same, digest = {}, {}, {}
    for label, dual, ls, io, batches in _teacher_cases():
        rng = np.random.default_rng(zlib.crc32(label.encode()))

        def arr(*shape, scale=0.3):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                                * np.float32(scale), device=dev)

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
        if ls:
            w.update(w_lsW=arr(31, z["A1"]), ls_bias=arr(z["A1"]))
        cast = torch.bfloat16 if io == "bfloat16" else torch.float32
        hp_like = dict(dual=dual, use_ta=False, att_units=z["AU"], att1_units=z["A1"],
                       att2_units=z["A2"], dec_units=z["DU"], zoneout_cell=0.1,
                       zoneout_output=0.1, prenet_drop_rate=0.5, io_dtype=io,
                       src1_kind="location_sensitive" if ls else "forward", ls_cumulative=True,
                       ls_kernel=31 if ls else 0, eval_zoneout=False)
        for batch in batches:
            lengths = np.clip(rng.integers(24, S + 1, batch), 24, S)
            lengths[0] = S
            lens = torch.tensor(lengths, device=dev)
            ops = dict(
                keys=arr(batch, S, A).to(cast), mem1=arr(batch, S, z["E1"]).to(cast),
                mem2=arr(batch, S, z["E2"]).to(cast) if dual else None, spk=None,
                score_bias=torch.where(torch.arange(S, device=dev)[None] < lens[:, None],
                                       0.0, -1e9).float(),
                hp_like=hp_like,
            )
            feeds = arr(batch, N, z["F"])
            masks = tuple(torch.tensor(rng.random((batch, N, u)) < 0.5, device=dev)
                          for u in (z["P1"], z["P2"]))
            cot = arr(batch, N, z["DU"], scale=1.0)
            fwd, bwd, results = [], [], []
            for i in range(6):
                wl = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
                feat, _ = fused_teacher.teacher_decode(weights=wl, feeds=feeds, seed=1234,
                                                       prenet_masks=masks, **ops)
                (feat * cot).sum().backward()
                if i:
                    fwd.append(fused_teacher.last_launch_ms("fwd"))
                    bwd.append(fused_teacher.last_launch_ms("bwd"))
                if i < 2:
                    results.append({"features": feat.detach(),
                                    **{k: v.grad for k, v in wl.items() if v.grad is not None}})
            name = label + (f"_b{batch}" if batch != B else "")
            out[f"{name}_fwd"], out[f"{name}_bwd"] = fwd, bwd
            differ = [k for k in results[0] if not torch.equal(results[0][k], results[1][k])]
            same[name] = True if not differ else differ
            hashed = hashlib.sha256()
            for k in sorted(results[0]):
                hashed.update(results[0][k].float().cpu().numpy().tobytes())
            digest[name] = hashed.hexdigest()
    return out, same, digest


# The BiGRU cases of --rnn: (label, kernel, io, batch, source length); B=1 at the
# request's source length, the rest ragged up to S.
RNN_CASES = tuple(
    (f"{kernel}_{io}" + (f"_b{batch}" if batch != B else ""), kernel, io, batch,
     97 if batch == 1 else S)
    for kernel, batches in (("bigru", (1, B, 128, 528, 1024)), ("bigru_bwd", (1, B)))
    for io in ("f32", "bf16") for batch in batches)


def _rnn_times(dev, rng, cases=(("bigru_bwd", "bigru_bwd", "f32", B, S),)):
    """Device times of the BiGRU kernels at C=H=128 from seeded weights: ``bigru``
    (the whole forward, input projection included) or its backward's carry kernel
    (``bigru_bwd``, on the operands the backward hands it), per case of ``cases``;
    runs of 20 launches (5 from B=528 on), medians over five runs."""
    import torch
    from self_attention_tacotron_torch.ops import fused_rnn

    def arr(*shape, scale=0.3):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32) * np.float32(scale),
                            device=dev)

    C = H = 128
    fan = 1.0 / np.sqrt(C + H)
    out = {}
    for label, kernel, io, batch, src in cases:
        dtype = torch.bfloat16 if io == "bf16" else torch.float32
        lengths = np.clip(rng.integers(24, src + 1, batch), 24, src)
        lengths[0] = src
        lens = torch.tensor(lengths, device=dev)
        xs = arr(batch, src, C, scale=1.0).to(dtype)
        params = [{"gates_kernel": arr(C + H, 2 * H, scale=fan),
                   "gates_bias": arr(2 * H, scale=0.1),
                   "candidate_kernel": arr(C + H, H, scale=fan),
                   "candidate_bias": arr(H, scale=0.1)} for _ in range(2)]
        inner = 20 if batch < 528 else 5
        if kernel == "bigru":
            pf, pb = ({k: v.to(dtype) for k, v in p.items()} for p in params)
            out[label] = _events_ms(lambda: fused_rnn.bigru(xs, lens, pf, pb, H), inner=inner)
            continue
        weights = [p[k] for p in params for k in fused_rnn._PARAM_KEYS]
        y = fused_rnn.bigru(xs, lens, params[0], params[1], H)
        rz, n, hp, _, _, wgh_t, wch_t = fused_rnn.bwd_operands(xs, y, weights, H)
        g_y = arr(batch, src, 2 * H, scale=1.0)
        out[label] = _events_ms(
            lambda: fused_rnn.bigru_bwd_carry(g_y, rz, n, hp, lens, wgh_t, wch_t), inner=inner)
    return out


# The LSTM cases of --rnn: (label, io, batch, source length), as RNN_CASES'.
LSTM_CASES = tuple(
    (f"bilstm_{io}" + (f"_b{batch}" if batch != B else ""), io, batch, 97 if batch == 1 else S)
    for io in ("f32", "bf16") for batch in (1, B, 128, 528, 1024))


def _lstm_times(dev, cases=LSTM_CASES):
    """Device times of ``bilstm`` (input projection and recurrence) at C=H=128,
    zoneout 0.1, from seeded weights, per case; runs of 20 launches (5 from B=528
    on), medians over five runs. A case draws its inputs from a seed of its own."""
    import torch
    from self_attention_tacotron_torch.ops import fused_rnn

    C = H = 128
    fan = 1.0 / np.sqrt(C + H)
    out = {}
    for label, io, batch, src in cases:
        rng = np.random.default_rng(zlib.crc32(label.encode()))

        def arr(*shape, scale):
            return torch.tensor(rng.standard_normal(shape).astype(np.float32)
                                * np.float32(scale), device=dev)

        dtype = torch.bfloat16 if io == "bf16" else torch.float32
        lengths = np.clip(rng.integers(24, src + 1, batch), 24, src)
        lengths[0] = src
        lens = torch.tensor(lengths, device=dev)
        xs = arr(batch, src, C, scale=1.0).to(dtype)
        pf, pb = ({"kernel": arr(C + H, 4 * H, scale=fan).to(dtype),
                   "bias": arr(4 * H, scale=0.1).to(dtype)} for _ in range(2))
        out[label] = _events_ms(lambda: fused_rnn.bilstm(xs, lens, pf, pb, H, 0.1, 0.1),
                                inner=20 if batch < 528 else 5)
    return out


# The cases of --mha: (label, io, batch, positions).
MHA_CASES = tuple(
    (f"mha_full_{io}" + (f"_b{batch}" if batch != B else "") + (f"_t{t}" if t != S else ""),
     io, batch, t)
    for io in ("f32", "bf16") for batch, t in ((1, 97), (B, S), (128, S), (528, S), (1, 3000)))


def _mha_times(dev, cases=MHA_CASES):
    """Device times of ``mha_full`` at D=256, 2 heads (the flagship's encoder) from
    seeded qkv, masked by ragged lengths (the longest lane full), per case; runs of 20
    launches (5 from B=528 and at T=3000), medians over five runs."""
    import torch
    from self_attention_tacotron_torch.ops import fused_attention

    D, heads = 256, 2
    out = {}
    for label, io, batch, t in cases:
        rng = np.random.default_rng(zlib.crc32(label.encode()))
        dtype = torch.bfloat16 if io == "bf16" else torch.float32
        lengths = np.clip(rng.integers(24, t + 1, batch), 1, t)
        lengths[0] = t
        qkv = torch.tensor(rng.standard_normal((batch, t, 3 * D)).astype(np.float32),
                           device=dev).to(dtype)
        mask = torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
        out[label] = _events_ms(lambda: fused_attention.mha_full(qkv, mask, heads),
                                inner=20 if batch < 528 and t <= S else 5)
    return out


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
    times, extra = {}, {}
    flags = args[2:]
    if "--rnn" in flags:
        times.update(_rnn_times(dev, np.random.default_rng(6), RNN_CASES))
        times.update(_lstm_times(dev))
    if "--mha" in flags:
        times.update(_mha_times(dev))
    if not flags or "--decode" in flags:
        times.update(_decode_times(dev))
    if not flags or "--teacher" in flags:
        teacher, extra["bit_for_bit"], extra["digest"] = _teacher_times(dev)
        times.update(teacher)
    if not flags:
        times.update(_rnn_times(dev, np.random.default_rng(6)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("AB " + json.dumps({"tree": label, "card": card, "ms": times,
                              "median": {k: float(np.median(v)) for k, v in times.items()},
                              **extra}),
          flush=True)


if __name__ == "__main__":
    main()
