"""The bfloat16 branch of the whole-loop decode (``ops/fused_decode.py``) and its
tiled self-attention, on the CPU, where ``fused_decode`` runs its plain version.

* ``fused_decode_reference`` at ``compute_dtype="bfloat16"`` (weights, keys,
  memories and K/V cache in bfloat16, every product's input rounded where the
  Pallas kernel casts it to its io dtype, sums and state in float32) against the
  JAX package's Pallas kernel in interpret mode (``make_predict_fn(model,
  use_fused=True)`` at ``compute_dtype="bfloat16"``), prenet dropout off, for the
  four pairs of the kernel's ``dual`` / ``use_sa`` flags: atol 3e-2 on mel, stop
  probabilities and alignments, lengths, flags and step counts exact, to the cap
  and with an early exit.
* the port's bfloat16 step-by-step path (flax's rounding) against the same
  plain version (the kernel's rounding), dropout 0.5 from the same masks: the
  two round at different points, atol 3e-2.
* float32: the plain version attending in tiles of 4 positions (12 steps: the
  online softmax over three tiles, as the kernel takes it beyond ``SA_TILE``
  steps) against the Pallas kernel, atol 1e-4, and against itself in one tile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_attention_tacotron_tpu.hparams import HParams as JaxHParams
from self_attention_tacotron_tpu.synthesis import make_predict_fn as jax_make_predict_fn

from self_attention_tacotron_torch.ops import fused_decode as fd
from self_attention_tacotron_torch.synthesis import make_predict_fn

from test_torch_fused_decode import (
    MAX_ITERS,
    VARIANTS,
    _as_dict,
    _batch,
    _compare,
    _flax_variables,
    _masks,
    _model,
    _threshold,
    _torch_net,
)
from test_torch_synthesis import _NARROW

TOL = 3e-2
# one variant per pair of flags (dual, use_sa)
FLAG_PAIRS = ("forward", "dual_source_decoder", "extended_decoder", "self_attention_decoder")
BF16 = {"compute_dtype": "bfloat16"}

_jax_runs = {}


def _run_jax_fused(variant, threshold, dtype="bfloat16"):
    key = (variant, threshold, dtype)
    if key not in _jax_runs:
        hp = JaxHParams(**{**_NARROW, **VARIANTS[variant], "decoder_prenet_drop_rate": 0.0,
                           "stop_token_threshold": threshold, "compute_dtype": dtype})
        predict = jax_make_predict_fn(_model(variant, hp, jax_side=True), max_iters=MAX_ITERS,
                                      use_fused=True)
        batch = {k: jnp.asarray(v) for k, v in _batch(variant).items()}
        out = predict(_flax_variables(variant), batch, jax.random.PRNGKey(11))
        _jax_runs[key] = jax.tree.map(np.asarray, out)
    return _jax_runs[key]


def _run_torch_fused(variant, threshold):
    net = _torch_net(variant, decoder_prenet_drop_rate=0.0, stop_token_threshold=threshold, **BF16)
    predict = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=True)
    return predict(_batch(variant))


def _errors(label, got, want):
    errs = {key: float(np.abs(np.asarray(got[key], np.float32) - np.asarray(want[key])).max())
            for key in ("mel", "stop_probs")}
    errs["alignments"] = max(
        float(np.abs(np.asarray(g, np.float32) - np.asarray(w)).max())
        for g, w in zip(got["alignments"], want["alignments"]))
    print(f"bf16 fused_decode {label}: max abs err {errs}")


@pytest.mark.parametrize("variant", FLAG_PAIRS)
def test_bf16_plain_version_matches_the_pallas_kernel_to_the_cap(variant):
    want = _run_jax_fused(variant, 2.0)
    got = _run_torch_fused(variant, 2.0)
    assert int(want["num_steps"]) == MAX_ITERS and not want["finished"].any()
    assert got["mel"].dtype == torch.float32 and float(got["mel"].abs().max()) > 0.0
    _errors(f"{variant} to the cap", got, want)
    _compare(got, want, atol=TOL)


@pytest.mark.parametrize("variant", FLAG_PAIRS)
def test_bf16_plain_version_matches_the_pallas_kernel_with_early_exit(variant):
    # no probability within 5e-3 of the threshold: "fired" cannot differ at TOL
    threshold = _threshold(_run_jax_fused(variant, 2.0)["stop_probs"], gap=1e-2)
    want = _run_jax_fused(variant, threshold)
    got = _run_torch_fused(variant, threshold)
    assert int(want["num_steps"]) < MAX_ITERS and want["finished"].all()
    assert len(set(want["lengths"].tolist())) > 1
    _errors(f"{variant} early exit", got, want)
    _compare(got, want, atol=TOL)


@pytest.mark.parametrize("variant", ("forward", "extended_decoder"))
def test_bf16_step_by_step_path_matches_the_plain_version(variant):
    net = _torch_net(variant, stop_token_threshold=2.0, **BF16)
    masks, batch = _masks(), _batch(variant)
    stepwise = make_predict_fn(net, max_iters=MAX_ITERS, device="cpu", use_fused=False)(
        batch, prenet_masks=masks)
    with torch.inference_mode():
        cond, _ = net.encode(torch.as_tensor(batch["source"]).long(),
                             torch.as_tensor(batch["source_lengths"]).long())
        packed = fd.pack_decoder(net.decoder)
        plain = fd.fused_decode_reference(packed, cond, masks, MAX_ITERS, 2.0)
    assert packed.flat.dtype == torch.bfloat16 and packed.flat32.dtype == torch.float32
    assert cond.memories[0].dtype == torch.bfloat16
    _errors(f"{variant} step by step against the plain version", stepwise, _as_dict(plain))
    _compare(_as_dict(plain), stepwise, atol=TOL)


def test_pack_rounds_the_weights_and_keeps_vectors_and_norms_float32():
    net = _torch_net("forward", **BF16)
    packed = fd.pack_decoder(net.decoder)
    w = net.decoder.prenet.Dense_0.weight.detach().t()
    assert torch.equal(packed.mat("p1_w"), w.to(torch.bfloat16))
    assert packed.mat("ln1_s").dtype == torch.float32
    assert torch.equal(packed.vec("ln1_s"), net.decoder.self_attention.block_0.ln1.weight.detach())
    assert torch.equal(packed.vec("v_cat")[:24], net.decoder.attention_0.attention_v[:, 0].detach())
    assert fd.variant_name(True, True, torch.bfloat16) == "dual=1,use_sa=1,bf16"


@pytest.mark.parametrize("variant", ("forward", "self_attention_decoder"))
def test_f32_attention_in_tiles_matches_the_pallas_kernel(variant):
    """The online softmax over tiles of the cache's prefix (the kernel's path beyond
    ``SA_TILE`` steps), reached here in 12 steps with tiles of 4 positions."""
    want = _run_jax_fused(variant, 2.0, dtype="float32")
    net = _torch_net(variant, decoder_prenet_drop_rate=0.0, stop_token_threshold=2.0)
    request = _batch(variant)
    with torch.inference_mode():
        cond, _ = net.encode(torch.as_tensor(request["source"]).long(),
                             torch.as_tensor(request["source_lengths"]).long())
        packed = fd.pack_decoder(net.decoder)
        tiled = fd.fused_decode_reference(packed, cond, None, MAX_ITERS, 2.0, sa_tile=4)
        whole = fd.fused_decode_reference(packed, cond, None, MAX_ITERS, 2.0)
    _errors(f"{variant} float32, tiles of 4", _as_dict(tiled), want)
    _compare(_as_dict(tiled), want, atol=1e-4)
    _compare(_as_dict(tiled), _as_dict(whole), atol=1e-5)
