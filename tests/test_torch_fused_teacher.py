"""The port's teacher-forced decode against the JAX package's fused kernels.

The same numpy inputs go through ``teacher_decode_reference`` of the port (the
plain version that the CUDA kernels are held against on the card) and through
``fused_teacher.teacher_decode(..., interpret=True)`` of the JAX package: forward
values and every gradient, with a non-zero cotangent for the alignments, for the
dual-source specialisation and for one source (``dual=False``: the baseline's
single forward attention, no second key, memory or alignment). Train zoneout is
compared value for value: both sides draw their keep masks from the same
counter-based hash. Prenet dropout is 0 (the frameworks' streams differ).

Tolerances: float32 on both sides, sums in another order: 1e-4 absolute on
values; gradients 1e-4 relative to the largest entry of the leaf.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import fused_teacher as jax_teacher

from self_attention_tacotron_torch.hparams import HParams
from self_attention_tacotron_torch.models.decoders import DecoderConditioning
from self_attention_tacotron_torch.models.models import TacotronNetwork
from self_attention_tacotron_torch.ops import fused_teacher

B, S, N, F = 3, 11, 6, 10
D = dict(P1=12, P2=8, AU=12, A1=12, A2=6, DU=16, E1=12, E2=8)

CASES = {
    "forward": dict(),
    "transition_agent": dict(use_ta=True),
    "speaker": dict(spk=5),
    "transition_agent_speaker": dict(use_ta=True, spk=4),
    "eval_zoneout": dict(zc=0.1, zo=0.15, eval_zoneout=True),
    "train_zoneout": dict(zc=0.3, zo=0.2),
    "train_zoneout_cell_only": dict(zc=0.25, zo=0.0, use_ta=True),
    "train_zoneout_output_only": dict(zc=0.0, zo=0.4),
    "single": dict(dual=False),
    "single_transition_agent_train_zoneout": dict(dual=False, use_ta=True, zc=0.3, zo=0.2),
    "single_speaker_eval_zoneout": dict(dual=False, spk=3, zc=0.1, zo=0.15, eval_zoneout=True),
}


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    spk = case.get("spk", 0)
    dual = case.get("dual", True)
    a2, e2 = (D["A2"], D["E2"]) if dual else (0, 0)
    a_tot = D["A1"] + a2
    in_att = D["P2"] + spk + D["E1"] + e2 + D["AU"]
    in1 = D["AU"] + D["E1"] + e2 + D["DU"]
    vblk = np.zeros((a_tot, 2 if dual else 1), np.float32)
    vblk[: D["A1"], 0] = r(D["A1"])
    if dual:
        vblk[D["A1"] :, 1] = r(D["A2"])
    weights = dict(
        w_p1=r(F, D["P1"]), b_p1=r(D["P1"]), w_p2=r(D["P1"], D["P2"]), b_p2=r(D["P2"]),
        w_attg=r(in_att, 4 * D["AU"]), b_attg=r(4 * D["AU"]), w_qp=r(D["AU"], a_tot),
        vblk=vblk, w_ta=r(D["E1"] + D["AU"], 1), b_ta=r(1),
        w_l1=r(in1, 4 * D["DU"]), b_l1=r(4 * D["DU"]),
        w_l2=r(2 * D["DU"], 4 * D["DU"]), b_l2=r(4 * D["DU"]),
    )
    lengths = np.array([S, 7, 4])
    conds = dict(
        keys=r(B, S, a_tot), mem1=r(B, S, D["E1"]), mem2=r(B, S, e2) if dual else None,
        spk=r(B, spk) if spk else None,
        score_bias=np.where(np.arange(S)[None, :] < lengths[:, None], 0.0, -1e9).astype(np.float32),
    )
    feeds = r(B, N, F)
    feeds[:, 0] = 0.0        # the go frame: with zero biases it would sit on the ReLU's tie
    cot = dict(features=r(B, N, D["DU"]) / 0.3, aligns=r(B, N, (2 if dual else 1) * S) / 0.3)
    return weights, conds, feeds, cot


def _hp_like(case):
    dual = case.get("dual", True)
    return dict(
        dual=dual, use_ta=case.get("use_ta", False), prenet_units=(D["P1"], D["P2"]),
        att_units=D["AU"], att1_units=D["A1"], att2_units=D["A2"] if dual else 0,
        dec_units=D["DU"],
        zoneout_cell=case.get("zc", 0.0), zoneout_output=case.get("zo", 0.0),
        prenet_drop_rate=0.0, io_dtype="float32", src1_kind="forward",
        eval_zoneout=case.get("eval_zoneout", False),
    )


SEED = 20240607


@functools.lru_cache(maxsize=None)
def _both(name):
    """(JAX outputs, JAX gradients, port outputs, port gradients) for one case."""
    case = CASES[name]
    weights, conds, feeds, cot = _inputs(case)
    hp_like = _hp_like(case)
    diff = {k: v for k, v in conds.items() if v is not None and k != "score_bias"}

    def jax_loss(w, c, f):
        full = dict(conds, **c)
        out = jax_teacher.teacher_decode(
            weights=w, keys=full["keys"], mem1=full["mem1"], mem2=full["mem2"],
            score_bias=jnp.asarray(conds["score_bias"]), spk=full["spk"], feeds=f,
            seed=jnp.asarray(SEED, jnp.int32), hp_like=hp_like, interpret=True,
        )
        return jnp.sum(out[0] * cot["features"]) + jnp.sum(out[1] * cot["aligns"]), out

    to_jax = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    (_, out_jax), grads_jax = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        to_jax(weights), to_jax(diff), jnp.asarray(feeds)
    )

    leaf = lambda x: torch.tensor(x, requires_grad=True)  # noqa: E731
    w_t = {k: leaf(v) for k, v in weights.items()}
    c_t = {k: leaf(v) for k, v in diff.items()}
    f_t = leaf(feeds)
    out_t = fused_teacher.teacher_decode_reference(
        weights=w_t, keys=c_t["keys"], mem1=c_t["mem1"], mem2=c_t.get("mem2"),
        score_bias=torch.tensor(conds["score_bias"]), spk=c_t.get("spk"), feeds=f_t,
        seed=SEED, hp_like=hp_like,
    )
    loss = (out_t[0] * torch.tensor(cot["features"])).sum()
    loss = loss + (out_t[1] * torch.tensor(cot["aligns"])).sum()
    loss.backward()
    grads_t = (
        {k: v.grad for k, v in w_t.items()}, {k: v.grad for k, v in c_t.items()}, f_t.grad
    )
    return out_jax, grads_jax, out_t, grads_t


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_the_jax_kernel(name):
    out_jax, _, out_t, _ = _both(name)
    for got, want in zip(out_t, out_jax):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    sums = out_t[1].detach().reshape(B, N, -1, S).sum(dim=-1)
    assert sums.shape[2] == (2 if CASES[name].get("dual", True) else 1)
    assert float((sums - 1.0).abs().max()) < 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_gradient_matches_the_jax_kernel(name):
    _, grads_jax, _, grads_t = _both(name)
    use_ta = CASES[name].get("use_ta", False)

    def close(got, want, label):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-3)
        np.testing.assert_allclose(
            got.numpy(), want, atol=1e-4 * scale, rtol=0, err_msg=f"{name}: {label}"
        )

    for key, want in grads_jax[0].items():
        if key in ("w_lsW", "ls_bias"):
            continue        # JAX's placeholders of forward attention (test_torch_fused_teacher_ls.py)
        if key in ("w_ta", "b_ta") and not use_ta:
            assert grads_t[0][key] is None or float(grads_t[0][key].abs().max()) == 0.0
            continue
        close(grads_t[0][key], want, f"weight {key}")
    for key, want in grads_jax[1].items():
        close(grads_t[1][key], want, f"conditioning {key}")
    close(grads_t[2], grads_jax[2], "feeds")


def test_train_zoneout_masks_differ_between_steps_and_seeds():
    masks = fused_teacher.hash_keep_masks(7, 4, 3, 16, 1, fused_teacher.keep_threshold(0.5), "cpu")
    assert masks.shape == (4, 3, 16) and masks.dtype == torch.bool
    assert 0.3 < float(masks.float().mean()) < 0.7
    assert not torch.equal(masks[0], masks[1])
    other = fused_teacher.hash_keep_masks(8, 4, 3, 16, 1, fused_teacher.keep_threshold(0.5), "cpu")
    assert torch.equal(masks[1], other[0])          # the step's seed is seed + t
    assert not torch.equal(masks, other)
    assert not fused_teacher.hash_keep_masks(7, 2, 3, 16, 1, 0, "cpu").any()
    assert fused_teacher.hash_keep_masks(
        7, 2, 3, 16, 1, fused_teacher.keep_threshold(1.0), "cpu"
    ).float().mean() > 0.99


def test_zoneout_draw_numbers_skip_disabled_kinds():
    assert fused_teacher._draw_numbers(0.1, 0.1) == [1, 2, 3, 4, 5, 6]
    assert fused_teacher._draw_numbers(0.1, 0.0) == [1, 0, 2, 0, 3, 0]
    assert fused_teacher._draw_numbers(0.0, 0.1) == [0, 1, 0, 2, 0, 3]
    assert fused_teacher._draw_numbers(0.0, 0.0) == [0] * 6


@pytest.mark.parametrize(
    "name", ["transition_agent_speaker", "train_zoneout", "forward", "single",
             "single_transition_agent_train_zoneout"]
)
def test_gradients_from_rows_equal_autograd(name):
    """The wrapper's batched products, fed with the rows the backward kernel
    writes (here built from the plain version and autograd's cotangents), give
    autograd's gradients: float32 sums in another order, 1e-5 relative."""
    case = CASES[name]
    weights, conds, feeds, cot = _inputs(case, seed=3)
    hp_like = _hp_like(case)
    leaf = lambda x: torch.tensor(x, requires_grad=True)  # noqa: E731
    w = {k: leaf(v) for k, v in weights.items()}
    keys, mem1 = leaf(conds["keys"]), leaf(conds["mem1"])
    mem2 = None if conds["mem2"] is None else leaf(conds["mem2"])
    spk = None if conds["spk"] is None else leaf(conds["spk"])
    x2 = fused_teacher._prenet(w, torch.tensor(feeds), 0.0, None, None)
    z = fused_teacher._sizes(hp_like, w, keys, mem1, mem2, spk, x2)
    taps = []
    features, aligns = fused_teacher._core_plain(
        hp_like, w, x2, keys, mem1, mem2, torch.tensor(conds["score_bias"]), spk, SEED, taps
    )
    stack_taps = ("z_att", "z1", "z2", "x2", "qp", "ctx1", "ctx2", "u_pre")
    for tap in taps:
        for key in stack_taps:
            if tap[key] is not None and tap[key].requires_grad:
                tap[key].retain_grad()
    ((features * torch.tensor(cot["features"])).sum()
     + (aligns * torch.tensor(cot["aligns"])).sum()).backward()

    layouts = fused_teacher.row_layouts(z, S)
    def field(tap, k, grad):
        # u_pre without the transition agent is one column of zeros; a field of
        # width 0 (one source: the second context) stays empty
        if tap[k] is None:
            return torch.zeros(B, 1)
        if not grad:
            return tap[k].detach()
        return torch.zeros_like(tap[k]) if tap[k].grad is None else tap[k].grad

    row = lambda names, tap, grad=False: torch.cat(  # noqa: E731
        [field(tap, k, grad).reshape(B, -1) for k in names], dim=-1
    )
    carries = torch.stack([row(fused_teacher._CARRY, tap) for tap in taps], dim=1)
    stack = torch.stack([row(stack_taps, tap, grad=True) for tap in taps], dim=1)
    assert carries.shape[-1] == layouts["carry"][1] and stack.shape[-1] == layouts["stack"][1]
    # what only the kernel computes is taken from autograd here
    at, width = layouts["stack"][0]["g_z_att"]
    d_vblk = torch.zeros(B, *w["vblk"].t().shape)
    d_vblk[0] = w["vblk"].grad.t()
    got = fused_teacher.grads_from_rows(
        z, hp_like["use_ta"], x2.detach(), None if spk is None else spk.detach(),
        aligns.detach(), carries, stack, stack.sum(dim=1), keys.grad, d_vblk,
        None if spk is None else spk.grad,
    )
    if mem2 is None:
        assert got["mem2"] is None
    for key in fused_teacher.CORE_WEIGHTS + ("mem1",) + (("mem2",) if mem2 is not None else ()):
        want = {"mem1": mem1, "mem2": mem2}.get(key, w.get(key)).grad
        if want is None:
            assert float(got[key].abs().max()) == 0.0, key
            continue
        scale = max(float(want.abs().max()), 1e-3)
        np.testing.assert_allclose(
            got[key].numpy(), want.numpy(), atol=1e-5 * scale, rtol=0, err_msg=key
        )
    assert at == 0 and width == 4 * D["AU"]


def test_row_layouts_are_contiguous_and_cover_the_row():
    """Every field has room but the cumulative alignments, which only
    location-sensitive attention over cumulative weights carries (``CUM``)."""
    z = dict(P2=8, SPK=0, AU=12, A1=12, A2=6, DU=16, E1=12, E2=8)
    for cum in (0, 1):
        for fields, total in fused_teacher.row_layouts(dict(z, CUM=cum), 11).values():
            at = 0
            for name, (offset, width) in fields.items():
                assert offset == at and (width > 0) == (name != "cum" or bool(cum))
                at += width
            assert at == total
    assert fused_teacher.row_layouts(z, 11)["carry"][1] == 2 * 12 + 4 * 16 + 12 + 8 + 11 + 1
    assert fused_teacher.row_layouts(dict(z, CUM=1), 11)["carry"][1] == (
        2 * 12 + 4 * 16 + 12 + 8 + 2 * 11 + 1)


def test_row_layouts_of_one_source_give_the_second_source_no_room():
    z = dict(P2=8, SPK=0, AU=12, A1=12, A2=0, DU=16, E1=12, E2=0)
    layouts = fused_teacher.row_layouts(z, 11)
    empty = {("carry", "ctx2"), ("carry", "cum"), ("acts", "alpha2"), ("stack", "g_ctx2")}
    for kind, (fields, total) in layouts.items():
        at = 0
        for name, (offset, width) in fields.items():
            assert offset == at and (width == 0) == ((kind, name) in empty)
            at += width
        assert at == total
    assert layouts["carry"][1] == 2 * 12 + 4 * 16 + 12 + 11 + 1
    assert layouts["acts"][1] == 4 * 12 + 8 * 16 + 12 + 11


def _flagship_hp(**overrides):
    hp = HParams(decoder="DualSourceSelfAttentionDecoder", attention="forward",
                 attention2="additive")
    return hp.override_from_dict(overrides)


# the WORLD heads (mgc, lf0): the feeds are wider, the scanned region the same
_WORLD = (
    {"decoder": "MgcLf0ExtendedDecoder"},
    {"decoder": "MgcLf0DualSourceSelfAttentionDecoder"},
)
# bfloat16 decoders are of the kernels' family: through them the teacher-forced
# pass hands its operands over in bfloat16
_BF16 = (
    {"compute_dtype": "bfloat16"},
    {"decoder": "ExtendedDecoder", "compute_dtype": "bfloat16"},
)


@pytest.mark.parametrize("overrides,expected", [
    ({}, True),
    ({"attention": "forward_transition_agent"}, True),
    ({"use_speaker_embedding": True}, True),
    ({"attention": "location_sensitive"}, True),
    ({"attention2": "forward"}, False),
    ({"compute_dtype": "bfloat16"}, True),
    ({"decoder_prenet_out_units": (256, 128, 64)}, False),
    ({"cbhg_out_units": 254}, False),
    ({"decoder_out_units": 768}, False),
    ({"decoder": "ExtendedDecoder"}, True),
    ({"decoder": "ExtendedDecoder", "attention2": "forward"}, True),
    ({"decoder": "ExtendedDecoder", "encoder": "ZoneoutEncoderV1"}, True),
    ({"decoder": "ExtendedDecoder", "encoder": "ZoneoutEncoderV1", "encoder_out_units": 254},
     False),
    ({"decoder": "ExtendedDecoder", "decoder_out_units": 512}, False),
    ({"decoder": "SelfAttentionDecoder"}, True),
    ({"decoder": "DualSourceDecoder"}, True),
    ({"decoder": "MgcLf0ExtendedDecoder"}, True),
    ({"decoder": "MgcLf0DualSourceSelfAttentionDecoder"}, True),
    ({"decoder": "ExtendedDecoder", "attention": "location_sensitive"}, True),
    ({"decoder": "ExtendedDecoder", "compute_dtype": "bfloat16"}, True),
    ({"decoder": "ExtendedDecoder", "attention": "location_sensitive",
      "compute_dtype": "bfloat16", "cumulative_weights": False}, True),
    ({"decoder": "ExtendedDecoder", "attention": "location_sensitive", "attention_kernel": 30},
     False),
    ({"decoder": "ExtendedDecoder", "attention": "location_sensitive", "attention_kernel": 33},
     False),
    ({"decoder": "SelfAttentionDecoder", "attention": "location_sensitive"}, False),
    ({"decoder": "DualSourceDecoder", "attention": "location_sensitive"}, False),
])
def test_supports_fused_teacher(overrides, expected):
    """``Decoder.fused_teacher_supported`` of the built decoder; the MgcLf0
    decoders (the WORLD heads) are of the kernels' family, their frames only wider
    feeds of the hoisted prenet; location-sensitive attention is served with an odd
    number of taps up to 32 on the two pairs of decoder flags a model class reaches
    (one source without self-attention, two with it); a bfloat16 decoder is of the
    kernels' family and hands the kernels bfloat16 keys and memories, float32
    weights, speaker embedding and score bias."""
    hp = _flagship_hp(**overrides)
    decoder = TacotronNetwork(hp).decoder
    assert decoder.fused_teacher_supported() is expected
    if overrides in _WORLD:
        assert decoder.output_heads == (("mgc", hp.num_mgcs), ("lf0", hp.num_lf0s))
        assert decoder.prenet.Dense_0.in_features == hp.num_mgcs + hp.num_lf0s
    if overrides in _BF16:
        assert decoder.compute_dtype == torch.bfloat16
        assert decoder._teacher_hp_like()["io_dtype"] == "bfloat16"
        n_src = decoder.num_attentions
        mems = tuple(torch.randn(2, 5, u).bfloat16() for u in decoder.memory_units)
        cond = DecoderConditioning(
            memories=mems, keys=decoder.compute_keys(mems),
            masks=tuple(torch.ones(2, 5, dtype=torch.bool) for _ in range(n_src)),
        )
        ops = decoder.teacher_operands(cond)
        assert ops["keys"].dtype == ops["mem1"].dtype == torch.bfloat16
        assert ops["score_bias"].dtype == torch.float32
        assert all(w.dtype == torch.float32 for w in ops["weights"].values())


def test_what_the_kernels_do_not_serve_raises():
    case = CASES["forward"]
    weights, conds, feeds, _ = _inputs(case)
    t = lambda x: None if x is None else torch.tensor(x)  # noqa: E731
    kwargs = dict(
        weights={k: t(v) for k, v in weights.items()}, keys=t(conds["keys"]),
        mem1=t(conds["mem1"]), mem2=t(conds["mem2"]), score_bias=t(conds["score_bias"]),
        spk=None, feeds=t(feeds), seed=0,
    )
    # location-sensitive attention needs its folded taps, and no other source-1 kind
    # is served
    with pytest.raises(ValueError, match="w_lsW"):
        fused_teacher.teacher_decode(
            hp_like=dict(_hp_like(case), src1_kind="location_sensitive", ls_kernel=5), **kwargs)
    with pytest.raises(ValueError, match="source 1 must use"):
        fused_teacher.teacher_decode(hp_like=dict(_hp_like(case), src1_kind="additive"), **kwargs)
    # bfloat16 runs with keys and memories in bfloat16; in float32 they are refused,
    # as is an io type the kernels are not compiled for
    bf16 = dict(kwargs, **{k: kwargs[k].bfloat16() for k in ("keys", "mem1", "mem2")})
    features, aligns = fused_teacher.teacher_decode(
        hp_like=dict(_hp_like(case), io_dtype="bfloat16"), **bf16)
    assert features.dtype == aligns.dtype == torch.float32
    assert bool(torch.isfinite(features).all()) and features.shape == (B, N, D["DU"])
    with pytest.raises(ValueError, match="io type"):
        fused_teacher.teacher_decode(hp_like=dict(_hp_like(case), io_dtype="bfloat16"), **kwargs)
    with pytest.raises(ValueError, match="io_dtype"):
        fused_teacher.teacher_decode(hp_like=dict(_hp_like(case), io_dtype="float16"), **kwargs)
    # a second memory goes with the dual-source specialisation, and only with it
    with pytest.raises(ValueError, match="second memory"):
        fused_teacher.teacher_decode(hp_like=dict(_hp_like(case), dual=False), **kwargs)
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        fused_teacher.teacher_decode(
            hp_like=_hp_like(case), **dict(kwargs, feeds=torch.zeros(B, N, F, device="meta"))
        )
