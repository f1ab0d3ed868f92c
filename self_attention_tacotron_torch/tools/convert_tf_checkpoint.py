"""Convert a reference TensorFlow checkpoint into the port's flat npz of weights.

``python -m self_attention_tacotron_torch.tools.convert_tf_checkpoint``: the port's
counterpart of ``tools/convert_tf_checkpoint.py``, with its own copy of the name
table. The TF-side variable names are reconstructed guesses, kept in one table
(``NAME_MAP``) so that they can be corrected once a real checkpoint is at hand:
``--list-only`` prints the checkpoint's own names.

The output is the flat npz layout of ``convert.py`` (``params/<JAX path>`` keys,
float32 arrays) of the part of the tree that ``NAME_MAP`` resolves (the encoder and
the self-attention rows are not mapped). ``convert.load_npz`` wants every leaf, so
merge it into a network instead::

    from self_attention_tacotron_torch.tools.convert_tf_checkpoint import merge_into_state
    net, loaded, skipped = merge_into_state(net, path)

TensorFlow is imported only to read a checkpoint (``load_tf_variables``).

Usage:
  python -m self_attention_tacotron_torch.tools.convert_tf_checkpoint <tf_ckpt_prefix> \\
      <out.npz> [--list-only]
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Tuple

import numpy as np

# JAX parameter path -> candidate TF variable names (reconstructed; ``{i}`` stands for
# a layer index) and the transform of the array. TF LSTM kernels are (in + units,
# 4 units) with gates (i, j, f, o), j the candidate: the port's (i, g, f, o).
NAME_MAP: List[Tuple[str, List[str], str]] = [
    ("embedding/embedding",
     ["embedding/embedding", "Embedding/embeddings"], "none"),
    ("decoder/prenet/Dense_0/kernel",
     ["decoder/prenets/dense/kernel", "decoder/prenet/dense/kernel"], "none"),
    ("decoder/prenet/Dense_0/bias",
     ["decoder/prenets/dense/bias", "decoder/prenet/dense/bias"], "none"),
    ("decoder/prenet/Dense_1/kernel",
     ["decoder/prenets/dense_1/kernel"], "none"),
    ("decoder/prenet/Dense_1/bias",
     ["decoder/prenets/dense_1/bias"], "none"),
    ("decoder/attention_lstm/gates/kernel",
     ["decoder/attention_rnn/lstm_cell/kernel"], "lstm_gate_order"),
    ("decoder/attention_lstm/gates/bias",
     ["decoder/attention_rnn/lstm_cell/bias"], "lstm_gate_order"),
    ("decoder/decoder_lstm_0/gates/kernel",
     ["decoder/decoder_rnn/multi_rnn_cell/cell_0/lstm_cell/kernel"], "lstm_gate_order"),
    ("decoder/decoder_lstm_0/gates/bias",
     ["decoder/decoder_rnn/multi_rnn_cell/cell_0/lstm_cell/bias"], "lstm_gate_order"),
    ("decoder/decoder_lstm_1/gates/kernel",
     ["decoder/decoder_rnn/multi_rnn_cell/cell_1/lstm_cell/kernel"], "lstm_gate_order"),
    ("decoder/decoder_lstm_1/gates/bias",
     ["decoder/decoder_rnn/multi_rnn_cell/cell_1/lstm_cell/bias"], "lstm_gate_order"),
    ("attention_0/memory_layer/kernel",
     ["memory_layer/kernel", "attention/memory_layer/kernel"], "none"),
    ("attention_0/attention_v",
     ["attention_v", "ForwardAttention/attention_v"], "expand_last"),
    ("attention_1/memory_layer/kernel",
     ["memory_layer_1/kernel"], "none"),
    ("attention_1/attention_v",
     ["attention_v_1"], "expand_last"),
    ("decoder/output_projection/kernel",
     ["decoder/frame_projection/kernel"], "none"),
    ("decoder/output_projection/bias",
     ["decoder/frame_projection/bias"], "none"),
]

# TF's LSTM gate order (i, j, f, o) is the port's (i, g, f, o): the identity, kept
# by name in case the reference differs
_TRANSFORMS = {
    "none": lambda x: x,
    "lstm_gate_order": lambda x: x,
    "expand_last": lambda x: x[:, None] if x.ndim == 1 else x,
}


def load_tf_variables(prefix: str) -> Dict[str, np.ndarray]:
    import tensorflow as tf  # only to read a checkpoint

    reader = tf.train.load_checkpoint(prefix)
    return {name: reader.get_tensor(name) for name in reader.get_variable_to_shape_map()}


def convert(tf_vars: Dict[str, np.ndarray]) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """(JAX path -> array, the JAX paths no TF variable matched)."""
    out: Dict[str, np.ndarray] = {}
    missing: List[str] = []
    for jax_path, candidates, transform in NAME_MAP:
        found = None
        for cand in candidates:
            for tf_name in tf_vars:
                if tf_name == cand or re.fullmatch(cand.replace("{i}", r"\d+"), tf_name):
                    found = tf_vars[tf_name]
                    break
            if found is not None:
                break
        if found is None:
            missing.append(jax_path)
            continue
        out[jax_path] = _TRANSFORMS[transform](np.asarray(found))
    return out, missing


def save_npz(flat: Dict[str, np.ndarray], path: str) -> None:
    """``convert``'s arrays as ``params/<path>`` float32 entries of a flat npz."""
    np.savez_compressed(path, **{f"params/{k}": np.asarray(v, np.float32)
                                 for k, v in flat.items()})


def merge_into_state(net, npz_path: str):
    """Overlay a converted (partial) npz onto the weights of the network ``net``.

    Returns ``(net, loaded_paths, skipped_paths)``, the paths without their
    ``params/`` prefix: an entry absent from the network, or of another shape, is
    skipped and reported rather than failing, so a partly mapped checkpoint still
    warm-starts the mapped modules (the JAX tool's ``merge_into_params``).
    """
    from self_attention_tacotron_torch import convert

    current = convert.torch_to_flax_flat(net)
    loaded: List[str] = []
    skipped: List[str] = []
    with np.load(npz_path) as donor:
        for key in donor.files:
            path = key.split("/", 1)[1] if key.startswith("params/") else key
            if key not in current:
                skipped.append(f"{path} (not in model)")
            elif tuple(donor[key].shape) != tuple(current[key].shape):
                skipped.append(f"{path} (shape {donor[key].shape} != model {current[key].shape})")
            else:
                current[key] = np.asarray(donor[key], current[key].dtype)
                loaded.append(path)
    state = convert.flax_to_torch_state(current, net.hparams, net)
    device = next(net.parameters()).device
    convert.load_state(net, {k: v.to(device) for k, v in state.items()})
    return net, loaded, skipped


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("tf_ckpt_prefix")
    p.add_argument("out_path", nargs="?")
    p.add_argument("--list-only", action="store_true")
    args = p.parse_args()

    tf_vars = load_tf_variables(args.tf_ckpt_prefix)
    if args.list_only:
        for name in sorted(tf_vars):
            print(name, tf_vars[name].shape)
        return
    if not args.out_path:
        sys.exit("out_path required unless --list-only")
    flat, missing = convert(tf_vars)
    for path in missing:
        print(f"WARNING: no TF variable matched {path!r}; update NAME_MAP")
    save_npz(flat, args.out_path)
    print(f"wrote {len(flat)} tensors -> {args.out_path} ({len(missing)} unresolved)")


if __name__ == "__main__":
    main()
