"""Sequential batch blocks of the teacher-forced decode (``ops/fused_teacher.py``).

A batch beyond one launch runs as blocks outside the autograd function, as the
JAX package's ``_decode_core`` runs them: the prenet and its dropout over the
whole batch first, then block ``i`` with the zoneout seed ``seed + i * 1000003``;
autograd sums the weight gradients over the blocks and concatenates the
conditioning gradients. Here, on the CPU (``teacher_decode_reference``, the plain
version the kernels are held against on the card), B = 5 in blocks of 2, 2 and 1:

* with train zoneout, the blocked run equals the per-block runs with their seeds:
  outputs, weight gradients summed, conditioning gradients concatenated (float32
  sums in another order: 1e-6 absolute, gradients 1e-6 of the leaf's largest
  entry);
* with zoneout 0 and prenet dropout from one generator, it equals the unsliced run
  to the same tolerances: the masks do not depend on the blocks;
* against the JAX package's ``teacher_decode(..., slice_batch=2, interpret=True)``
  (its ragged last block padded to 8 lanes) with zoneout 0 and with eval zoneout
  (the two frameworks' train-zoneout streams agree only per launch): 1e-4 on
  values, gradients 1e-4 of the leaf's largest entry, as
  ``test_torch_fused_teacher.py`` holds one launch.

The automatic block size is a function of the shapes and the card's total memory
alone (checked with a stand-in for the card, as none is here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.ops import fused_teacher as jax_teacher

from self_attention_tacotron_torch.ops import fused_teacher

from test_torch_fused_teacher import CASES, D, F, N, S, SEED, _hp_like

B = 5
BLOCK = 2
LENGTHS = np.array([S, 7, 4, 9, 2])


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    spk = case.get("spk", 0)
    dual = case.get("dual", True)
    a2, e2 = (D["A2"], D["E2"]) if dual else (0, 0)
    a_tot = D["A1"] + a2
    vblk = np.zeros((a_tot, 2 if dual else 1), np.float32)
    vblk[: D["A1"], 0] = r(D["A1"])
    if dual:
        vblk[D["A1"] :, 1] = r(D["A2"])
    weights = dict(
        w_p1=r(F, D["P1"]), b_p1=r(D["P1"]), w_p2=r(D["P1"], D["P2"]), b_p2=r(D["P2"]),
        w_attg=r(D["P2"] + spk + D["E1"] + e2 + D["AU"], 4 * D["AU"]), b_attg=r(4 * D["AU"]),
        w_qp=r(D["AU"], a_tot), vblk=vblk, w_ta=r(D["E1"] + D["AU"], 1), b_ta=r(1),
        w_l1=r(D["AU"] + D["E1"] + e2 + D["DU"], 4 * D["DU"]), b_l1=r(4 * D["DU"]),
        w_l2=r(2 * D["DU"], 4 * D["DU"]), b_l2=r(4 * D["DU"]),
    )
    conds = dict(
        keys=r(B, S, a_tot), mem1=r(B, S, D["E1"]), mem2=r(B, S, e2) if dual else None,
        spk=r(B, spk) if spk else None,
        score_bias=np.where(np.arange(S)[None, :] < LENGTHS[:, None], 0.0, -1e9).astype(np.float32),
    )
    feeds = r(B, N, F)
    feeds[:, 0] = 0.0
    cot = dict(features=r(B, N, D["DU"]) / 0.3, aligns=r(B, N, (2 if dual else 1) * S) / 0.3)
    return weights, conds, feeds, cot


def _port(case, hp_like, lanes=slice(None), seed=SEED, slice_batch=None, generator=None,
          inputs=None):
    """Outputs and gradients (weights, conditioning, feeds) of the lanes ``lanes``."""
    weights, conds, feeds, cot = inputs or _inputs(case)
    leaf = lambda x: torch.tensor(x, requires_grad=True)  # noqa: E731
    w = {k: leaf(v) for k, v in weights.items()}
    c = {k: leaf(v[lanes]) for k, v in conds.items() if v is not None and k != "score_bias"}
    f = leaf(feeds[lanes])
    out = fused_teacher.teacher_decode(
        weights=w, keys=c["keys"], mem1=c["mem1"], mem2=c.get("mem2"),
        score_bias=torch.tensor(conds["score_bias"][lanes]), spk=c.get("spk"), feeds=f,
        seed=seed, hp_like=hp_like, slice_batch=slice_batch, generator=generator,
    )
    loss = (out[0] * torch.tensor(cot["features"][lanes])).sum()
    (loss + (out[1] * torch.tensor(cot["aligns"][lanes])).sum()).backward()
    return (tuple(o.detach() for o in out), {k: v.grad for k, v in w.items()},
            {k: v.grad for k, v in c.items()}, f.grad)


def _close(got, want, atol, label):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got), want, atol=atol * scale, rtol=0, err_msg=label)


def _assert_same(got, want, atol):
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)
    for key, value in want[1].items():
        if value is None:
            assert got[1][key] is None or float(got[1][key].abs().max()) == 0.0, key
        else:
            _close(got[1][key], value, atol, f"weight {key}")
    for key, value in want[2].items():
        _close(got[2][key], value, atol, f"conditioning {key}")
    _close(got[3], want[3], atol, "feeds")


def _blockwise(case, hp_like):
    """The per-block runs, each with its own seed, put together as a blocked run
    should: outputs and conditioning gradients concatenated, weight gradients summed."""
    parts = [_port(case, hp_like, slice(start, start + BLOCK), SEED + i * 1000003)
             for i, start in enumerate(range(0, B, BLOCK))]
    outs = tuple(torch.cat([p[0][j] for p in parts]) for j in range(2))
    weights = {}
    for key in parts[0][1]:
        grads = [p[1][key] for p in parts if p[1][key] is not None]
        weights[key] = sum(grads) if grads else None
    conds = {key: torch.cat([p[2][key] for p in parts]) for key in parts[0][2]}
    return outs, weights, conds, torch.cat([p[3] for p in parts])


@pytest.mark.parametrize("name", ["train_zoneout", "single_transition_agent_train_zoneout",
                                  "transition_agent_speaker"])
def test_blocks_are_the_per_block_runs_with_their_seeds(name):
    case = CASES[name]
    hp_like = _hp_like(case)
    blocked = _port(case, hp_like, slice_batch=BLOCK)
    _assert_same(blocked, _blockwise(case, hp_like), atol=1e-6)
    if hp_like["zoneout_cell"] or hp_like["zoneout_output"]:
        # the masks of the second block differ from those it would have in one launch
        whole = _port(case, hp_like)
        assert float((whole[0][0][BLOCK:] - blocked[0][0][BLOCK:]).abs().max()) > 1e-4


@pytest.mark.parametrize("name", ["forward", "single", "transition_agent_speaker"])
def test_blocks_without_zoneout_are_the_unsliced_run(name):
    """Prenet dropout 0.5 from one generator: drawn for the whole batch before the
    blocks, so the blocked run and the unsliced run drop the same units."""
    case = CASES[name]
    hp_like = dict(_hp_like(case), prenet_drop_rate=0.5)
    whole = _port(case, hp_like, generator=torch.Generator().manual_seed(3))
    blocked = _port(case, hp_like, slice_batch=BLOCK, generator=torch.Generator().manual_seed(3))
    _assert_same(blocked, whole, atol=1e-6)
    one_lane = _port(case, hp_like, slice_batch=1, generator=torch.Generator().manual_seed(3))
    _assert_same(one_lane, whole, atol=1e-6)


def _jax(case, hp_like):
    weights, conds, feeds, cot = _inputs(case)
    diff = {k: v for k, v in conds.items() if v is not None and k != "score_bias"}

    def loss(w, c, f):
        full = dict(conds, **c)
        out = jax_teacher.teacher_decode(
            weights=w, keys=full["keys"], mem1=full["mem1"], mem2=full["mem2"],
            score_bias=jnp.asarray(conds["score_bias"]), spk=full["spk"], feeds=f,
            seed=jnp.asarray(SEED, jnp.int32), hp_like=hp_like, interpret=True,
            slice_batch=BLOCK,
        )
        return jnp.sum(out[0] * cot["features"]) + jnp.sum(out[1] * cot["aligns"]), out

    to_jax = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        to_jax(weights), to_jax(diff), jnp.asarray(feeds))
    return out, grads


@pytest.mark.parametrize("name", ["eval_zoneout", "single_speaker_eval_zoneout",
                                  "transition_agent"])
def test_blocks_match_the_jax_package_s_blocks(name):
    case = CASES[name]
    hp_like = _hp_like(case)
    want_out, (want_w, want_c, want_f) = _jax(case, hp_like)
    got = _port(case, hp_like, slice_batch=BLOCK)
    for g, w in zip(got[0], want_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    use_ta = case.get("use_ta", False)
    for key, value in want_w.items():
        if key in ("w_lsW", "ls_bias") or (key in ("w_ta", "b_ta") and not use_ta):
            continue        # placeholders of what the case does not have
        _close(got[1][key], value, 1e-4, f"weight {key}")
    for key, value in want_c.items():
        _close(got[2][key], value, 1e-4, f"conditioning {key}")
    _close(got[3], want_f, 1e-4, "feeds")


def test_the_automatic_block_size_reads_the_total_memory_only(monkeypatch):
    """Lanes whose per-step rows fit ROW_MEMORY_SHARE of the card's total memory;
    a raise where not one lane fits. The free memory is never asked."""
    weights, conds, feeds, _ = _inputs(CASES["forward"])
    hp_like = _hp_like(CASES["forward"])
    w = {k: torch.tensor(v) for k, v in weights.items()}
    x2 = fused_teacher._prenet(w, torch.tensor(feeds), 0.0, None, None)
    z = fused_teacher._sizes(hp_like, w, torch.tensor(conds["keys"]), torch.tensor(conds["mem1"]),
                             torch.tensor(conds["mem2"]), None, x2)
    per_lane = fused_teacher.row_bytes_per_lane(z, S, N)
    layouts = fused_teacher.row_layouts(z, S)
    assert per_lane == N * 4 * (2 * (D["DU"] + 2 * S) + 3 * layouts["carry"][1]
                                + layouts["acts"][1] + layouts["stack"][1])
    assert fused_teacher.row_bytes_per_lane(z, S, N, torch.bfloat16) < per_lane

    class Card:
        total_memory = 1000 * per_lane

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Card)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: pytest.fail("the free memory was asked"))
    assert fused_teacher.teacher_max_batch(z, S, N, "card") == int(
        fused_teacher.ROW_MEMORY_SHARE * 1000)
    assert fused_teacher.teacher_max_batch(z, S, 4 * N, "card") == int(
        fused_teacher.ROW_MEMORY_SHARE * 1000) // 4
    Card.total_memory = per_lane
    with pytest.raises(RuntimeError, match="one lane's rows"):
        fused_teacher.teacher_max_batch(z, S, N, "card")
    with pytest.raises(ValueError, match="slice_batch"):
        _port(CASES["forward"], hp_like, slice_batch=0)
