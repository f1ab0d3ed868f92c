"""The JAX side of ``test_torch_trained_step.py``, run in a process of its own.

    XLA_FLAGS=--xla_allow_excess_precision=false JAX_PLATFORMS=cpu \\
        python tests/torch_trained_step_jax.py CORPUS IDS FRAMES NPZ OVERRIDES OUT

Makes the batch of the utterances ``IDS`` (comma-separated, in lane order) of the
corpus directory ``CORPUS`` with the JAX package's data layer, cut to ``FRAMES``
target frames, loads the flat ``NPZ`` (``_variables_from_npz``) and takes one update
of ``Trainer._train_step_impl`` (the XLA scan) with the hparams ``OVERRIDES`` (their
compute dtype among them), jitted, with its gradients. ``--xla_allow_excess_precision=false`` keeps XLA from carrying float32
between fused bfloat16 operations, so that the jitted bfloat16 step rounds where the
step run operation by operation under ``jax.disable_jit`` does (the loss parts the
same bits, the gradient leaves the same or within 2e-7 of each other, measured on
``test_torch_training.py``'s narrow flagship), which is the port's bfloat16
semantics; the flag must be set before JAX starts, hence the process of its own.
Writes ``OUT`` (an npz): ``batch/<field>``, ``metrics/<name>``, ``grads/<leaf>`` and
``updated/<leaf>``.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from self_attention_tacotron_tpu.data.dataset import TacotronDataset
from self_attention_tacotron_tpu.hparams import HParams
from self_attention_tacotron_tpu.models.models import tacotron_model_factory
from self_attention_tacotron_tpu.training import trainer as jax_trainer

from test_torch_helpers import flat_variables


def cut_batch(batch, frames: int):
    """The batch's first ``frames`` target frames (lengths clipped to them)."""
    out = {k: v for k, v in batch.items() if k != "id"}
    out["mel"] = out["mel"][:, :frames]
    out["done"] = out["done"][:, :frames]
    out["target_lengths"] = np.minimum(out["target_lengths"], frames).astype(np.int32)
    return out


def main(corpus, ids, frames, npz, overrides, out_path):
    hp = HParams()
    hp.parse(overrides)
    data = TacotronDataset(corpus, corpus, hp, utterance_ids=ids)
    batch = cut_batch(data.make_batch([data.load_utterance(i) for i in ids]), frames)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_trainer._variables_from_npz(npz)
    model = tacotron_model_factory(hp)
    jt = jax_trainer.Trainer(model, f"{out_path}.ckpt")
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax_trainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, opt_state=jt.tx.init(params),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    key = jax.random.PRNGKey(0)

    def step_and_grads(state):
        def loss_fn(p):
            o, _ = jt._forward(jt.net, p, state.batch_stats, jbatch, key, mutable=True)
            return model.loss(o, jbatch, params=p)["loss"]

        return jt._train_step_impl(state, jbatch, key), jax.grad(loss_fn)(state.params)

    (state, metrics), grads = jax.jit(step_and_grads)(state)
    out = {f"batch/{k}": v for k, v in batch.items()}
    out.update({f"metrics/{k}": np.float64(v) for k, v in metrics.items()})
    out.update({f"grads/{k}": v for k, v in flat_variables({"params": grads}).items()})
    out.update({f"updated/{k}": v for k, v in flat_variables(
        {"params": state.params, "batch_stats": state.batch_stats}).items()})
    np.savez(out_path, **out)


if __name__ == "__main__":
    corpus, ids, frames, npz, overrides, out_path = sys.argv[1:7]
    main(corpus, ids.split(","), int(frames), npz, overrides, out_path)
