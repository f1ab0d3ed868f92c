"""Shared helpers of the PyTorch port's parity tests (no tests of its own).

Both frameworks get the same numpy inputs; flax variables go through
``convert.flax_to_torch_state`` into the port's module.
"""

import flax
import numpy as np
import torch

from self_attention_tacotron_torch import convert


def flat_variables(variables):
    """Flax variables -> the flat ``params/a/b/kernel`` layout, numpy leaves."""
    flat = {}
    for collection, tree in variables.items():
        for key, value in flax.traverse_util.flatten_dict(dict(tree), sep="/").items():
            flat[f"{collection}/{key}"] = np.asarray(value, dtype=np.float32)
    return flat


def load_from_flax(module, variables, hp=None):
    """Fill a port module with its flax twin's variables; returns it in eval mode."""
    state = convert.flax_to_torch_state(flat_variables(variables), hp, module)
    return convert.load_state(module, state).eval()


def t(array, dtype=None):
    return torch.as_tensor(np.asarray(array), dtype=dtype)


def assert_close(got, want, atol, rtol=0.0):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32), atol=atol, rtol=rtol)
