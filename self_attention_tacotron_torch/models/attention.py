"""Attention mechanisms: additive, location-sensitive, forward and teacher-forcing attention.

Counterpart of ``self_attention_tacotron_tpu/models/attention.py``. Every
mechanism is a step function whose whole recursion state lives in an explicit
:class:`AttentionState`. Scores and softmax are float32; in bfloat16 the tanh
of keys plus query is taken in bfloat16 and then to float32, and the context is
the alignments cast to the memory's dtype times the memory, as the JAX package
does it.

Location-sensitive attention (Tacotron 2) adds to the score's sum a dense layer
over a SAME convolution of the previous or the cumulative alignments.

Forward attention follows Zhang & Ling (ICASSP 2018):
a_i(n) = ((1 - u) a_i(n-1) + u a_{i-1}(n-1) + eps) * y_i(n), renormalised,
with an optional transition agent that produces u.

Teacher-forcing attention (``teacher_forcing_forward``, ``teacher_forcing_additive``,
forced-alignment mode) is the JAX package's pair of networks in one module: its
training network builds the forward or additive mechanism under the name without
the prefix, and its prediction network builds ``TeacherForcingAttention``, a
Gaussian window along the diagonal that reads the shared ``memory_layer``'s tree
and nothing else. So here the mechanism computes the wrapped one in train mode and
the window in eval mode, on the wrapped one's parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from self_attention_tacotron_torch.models.modules import Dense, _same_padding, sigmoid

_EPS = 1e-6
_NEG_INF = -1e9


@dataclasses.dataclass
class AttentionState:
    """Carry of one attention mechanism inside the decoder loop."""

    alignments: torch.Tensor   # (B, S) previous alignments
    cumulative: torch.Tensor   # (B, S) cumulative alignments
    transition: torch.Tensor   # (B, 1) forward-attention transition probability u
    step: int                  # decoder step

    def replace(self, **changes) -> "AttentionState":
        return dataclasses.replace(self, **changes)


def initial_attention_state(
    batch: int, src_len: int, *, initial_alignment: str = "uniform", device=None
) -> AttentionState:
    """Fresh state. Forward attention needs ``one_hot`` (all mass at index 0)."""
    if initial_alignment == "one_hot":
        align = torch.zeros(batch, src_len, dtype=torch.float32, device=device)
        align[:, 0] = 1.0
    else:
        align = torch.full((batch, src_len), 1.0 / src_len, dtype=torch.float32, device=device)
    return AttentionState(
        alignments=align,
        cumulative=torch.zeros(batch, src_len, dtype=torch.float32, device=device),
        transition=torch.full((batch, 1), 0.5, dtype=torch.float32, device=device),
        step=0,
    )


def _masked_softmax(score: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is not None:
        score = score.masked_fill(~mask, _NEG_INF)
    return torch.softmax(score.float(), dim=-1)


def _context(alignments: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    # (B, S) @ (B, S, E) -> (B, E)
    return torch.bmm(alignments.to(memory.dtype).unsqueeze(1), memory).squeeze(1)


class _AdditiveScore(nn.Module):
    """score = v^T tanh(Wq q + keys), shared by the additive and forward mechanisms.

    ``own_query_layer=False`` leaves the query projection to the caller: the
    dual-source decoder projects the queries of both mechanisms in one matrix
    product and hands each its slice as ``projected_query``.
    """

    initial_alignment = "uniform"
    flax_init = {"attention_v": ("glorot_uniform",)}

    def __init__(self, query_units: int, memory_units: int, num_units: int,
                 own_query_layer: bool = True):
        super().__init__()
        self.num_units = num_units
        self.memory_layer = Dense(memory_units, num_units, bias=False)
        self.query_layer = (
            Dense(query_units, num_units, bias=False) if own_query_layer else None
        )
        self.attention_v = nn.Parameter(torch.empty(num_units, 1))
        nn.init.xavier_uniform_(self.attention_v)

    def compute_keys(self, memory: torch.Tensor) -> torch.Tensor:
        return self.memory_layer(memory)

    def _score(self, query, keys, projected_query=None) -> torch.Tensor:
        if projected_query is None:
            if self.query_layer is None:
                raise ValueError("this mechanism has no query layer: pass projected_query")
            projected_query = self.query_layer(query)
        hidden = torch.tanh(keys + projected_query[:, None, :]).float()
        return torch.matmul(hidden, self.attention_v[:, 0].float())


class AdditiveAttention(_AdditiveScore):
    """Bahdanau additive attention."""

    def forward(self, query, keys, memory, mask, state: AttentionState, projected_query=None):
        probs = _masked_softmax(self._score(query, keys, projected_query), mask)
        new_state = state.replace(
            alignments=probs, cumulative=state.cumulative + probs, step=state.step + 1
        )
        return _context(probs, memory), probs, new_state


class LocationSensitiveAttention(_AdditiveScore):
    """Additive attention plus convolutional features of the alignments (Tacotron 2):
    score = v^T tanh(keys + Wq q + location_layer(conv(prev)) + attention_b), where
    ``prev`` is the cumulative alignments with ``cumulative_weights``, else the
    previous ones, and the convolution is SAME over the source axis: one channel in,
    ``attention_filters`` out, ``attention_kernel`` taps, with a bias.

    In bfloat16, as flax computes it: ``prev`` rounded, the convolution and its
    bias, the dense layer and the sum before the tanh each in bfloat16.
    """

    compute_dtype = torch.float32
    flax_init = {"attention_v": ("glorot_uniform",), "attention_b": ("zeros",)}

    def __init__(self, query_units: int, memory_units: int, num_units: int,
                 attention_kernel: int = 31, attention_filters: int = 32,
                 cumulative_weights: bool = True, own_query_layer: bool = True):
        super().__init__(query_units, memory_units, num_units, own_query_layer)
        self.attention_kernel = attention_kernel
        self.cumulative_weights = cumulative_weights
        self.location_conv = nn.Conv1d(1, attention_filters, attention_kernel)
        self.location_layer = Dense(attention_filters, num_units, bias=False)
        self.attention_b = nn.Parameter(torch.zeros(num_units))

    def location_features(self, prev: torch.Tensor) -> torch.Tensor:
        """(B, S) alignments -> (B, S, num_units) in the compute dtype."""
        dtype = self.compute_dtype
        x = F.pad(prev.to(dtype)[:, None, :], _same_padding(self.attention_kernel))
        f = F.conv1d(x, self.location_conv.weight.to(dtype))
        f = f + self.location_conv.bias.to(dtype)[None, :, None]
        return self.location_layer(f.transpose(1, 2))

    def forward(self, query, keys, memory, mask, state: AttentionState, projected_query=None):
        if projected_query is None:
            if self.query_layer is None:
                raise ValueError("this mechanism has no query layer: pass projected_query")
            projected_query = self.query_layer(query)
        prev = state.cumulative if self.cumulative_weights else state.alignments
        loc = self.location_features(prev)
        bias = self.attention_b.to(loc.dtype)
        hidden = torch.tanh(keys + projected_query[:, None, :] + loc + bias).float()
        probs = _masked_softmax(torch.matmul(hidden, self.attention_v[:, 0].float()), mask)
        new_state = state.replace(
            alignments=probs, cumulative=state.cumulative + probs, step=state.step + 1
        )
        return _context(probs, memory), probs, new_state


def location_fold(mech: LocationSensitiveAttention) -> Tuple[torch.Tensor, torch.Tensor]:
    """The convolution and the dense layer after it folded into one linear map of
    the taps, in float32 and under autograd, as the kernels take it:
    ``(w (K, units), bias (units,))`` with ``w = conv[:, 0, :] @ location_layer`` and
    ``bias = conv_bias @ location_layer + attention_b``."""
    conv = mech.location_conv.weight[:, 0, :].t().float()        # (K, filters)
    dense = mech.location_layer.weight.t().float()               # (filters, units)
    return conv @ dense, mech.location_conv.bias.float() @ dense + mech.attention_b.float()


class ForwardAttention(_AdditiveScore):
    """Forward attention with optional transition agent.

    Probability mass can only stay (weight 1 - u) or advance one position
    (weight u) before it is reweighted by the additive posterior and
    renormalised.
    """

    initial_alignment = "one_hot"

    def __init__(self, query_units: int, memory_units: int, num_units: int,
                 use_transition_agent: bool = False, own_query_layer: bool = True):
        super().__init__(query_units, memory_units, num_units, own_query_layer)
        self.transition_factor = (
            Dense(memory_units + query_units, 1) if use_transition_agent else None
        )

    def forward(self, query, keys, memory, mask, state: AttentionState, projected_query=None):
        y = _masked_softmax(self._score(query, keys, projected_query), mask)
        u = state.transition
        prev = state.alignments
        shifted = F.pad(prev, (1, 0))[:, :-1]  # a_{i-1}(n-1)
        alpha_hat = ((1.0 - u) * prev + u * shifted + _EPS) * y
        probs = alpha_hat / alpha_hat.sum(dim=-1, keepdim=True)
        context = _context(probs, memory)
        if self.transition_factor is not None:
            ta_in = torch.cat([context, query.to(context.dtype)], dim=-1)
            new_u = sigmoid(self.transition_factor(ta_in)).float()
        else:
            new_u = u
        new_state = state.replace(
            alignments=probs,
            cumulative=state.cumulative + probs,
            transition=new_u,
            step=state.step + 1,
        )
        return context, probs, new_state


class TeacherForcingAttention(nn.Module):
    """Forced diagonal alignment, mixed in before the mechanism it stands for.

    In eval mode the alignment is a softmax, masked as every mechanism's, of a
    Gaussian window of width ``window`` centred at ``min(step * ratio, S - 1)``,
    with ``ratio`` (B,) the source positions per decoder step (``S / T_dec`` of
    the true lengths; 1 where not given), all in float32; the query and keys are
    not read, and the forward-attention transition is carried unchanged. In train
    mode it is the mechanism it is mixed into.
    """

    window = 3.0

    def forward(self, query, keys, memory, mask, state: AttentionState, projected_query=None,
                ratio=None):
        if self.training:
            return super().forward(query, keys, memory, mask, state,
                                   projected_query=projected_query)
        b, s = memory.shape[:2]
        if ratio is None:
            ratio = torch.ones(b, dtype=torch.float32, device=memory.device)
        step = torch.tensor(float(state.step), dtype=torch.float32, device=memory.device)
        center = torch.clamp(step * ratio.float(), max=s - 1.0)
        pos = torch.arange(s, dtype=torch.float32, device=memory.device)[None, :]
        logit = -((pos - center[:, None]) ** 2) / (2.0 * self.window ** 2)
        probs = _masked_softmax(logit, mask)
        new_state = state.replace(
            alignments=probs, cumulative=state.cumulative + probs, step=state.step + 1
        )
        return _context(probs, memory), probs, new_state


class TeacherForcingForwardAttention(TeacherForcingAttention, ForwardAttention):
    """``teacher_forcing_forward``: forward attention in training, the window in eval."""


class TeacherForcingAdditiveAttention(TeacherForcingAttention, AdditiveAttention):
    """``teacher_forcing_additive``: additive attention in training, the window in eval."""


def attention_factory(
    name: str,
    num_units: int,
    hparams,
    query_units: int,
    memory_units: int,
    own_query_layer: bool = True,
) -> nn.Module:
    """Map an hparams attention name to a mechanism instance."""
    kw = dict(
        query_units=query_units, memory_units=memory_units, num_units=num_units,
        own_query_layer=own_query_layer,
    )
    if name == "additive":
        return AdditiveAttention(**kw)
    if name == "location_sensitive":
        return LocationSensitiveAttention(
            attention_kernel=hparams.attention_kernel,
            attention_filters=hparams.attention_filters,
            cumulative_weights=hparams.cumulative_weights,
            **kw,
        )
    if name == "forward":
        return ForwardAttention(
            use_transition_agent=hparams.use_forward_attention_transition_agent, **kw
        )
    if name == "forward_transition_agent":
        return ForwardAttention(use_transition_agent=True, **kw)
    if name == "teacher_forcing_forward":
        return TeacherForcingForwardAttention(
            use_transition_agent=hparams.use_forward_attention_transition_agent, **kw
        )
    if name == "teacher_forcing_additive":
        return TeacherForcingAdditiveAttention(**kw)
    raise ValueError(f"unknown attention mechanism: {name!r}")
