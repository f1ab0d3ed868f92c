"""Flat hyper-parameter namespace of the PyTorch port.

The port's own copy of the JAX package's ``hparams.py``: same fields, same
defaults, same parsing, so a configuration means the same thing on both sides.

Reference: ``self-attention-tacotron/hparams.py`` (SURVEY.md §2.1 — single
flat ``tf.contrib.training.HParams`` namespace). The mechanism is faithful:

* one flat namespace of defaults (:func:`default_hparams`)
* ``--hparams=key=value,key=value`` comma-separated CLI overrides
  (:meth:`HParams.parse`)
* JSON-file overrides (:meth:`HParams.override_from_json_file`)

Implemented as a plain dataclass (no TF dependency): values are typed, and
``parse`` coerces strings to the declared field type, including tuples and
booleans, like ``tf.contrib.training.HParams.parse`` did.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional, Tuple


def _coerce(value: str, ref: Any) -> Any:
    """Coerce a CLI string to the type of the current/default value."""
    if isinstance(ref, bool):
        if value.lower() in ("true", "1", "yes"):
            return True
        if value.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if isinstance(ref, int):
        return int(value)
    if isinstance(ref, float):
        return float(value)
    if isinstance(ref, (tuple, list)):
        items = [v for v in value.strip("[]()").split("+") if v]
        if len(ref) > 0:
            return tuple(_coerce(v, ref[0]) for v in items)
        # empty default tuple (e.g. average_mel_level_db): infer element
        # type from the string — int if every item parses as int, else float
        def _infer(v: str):
            try:
                return int(v)
            except ValueError:
                return float(v)
        return tuple(_infer(v) for v in items)
    if ref is None or isinstance(ref, str):
        if value.lower() == "none":
            return None
        return value
    raise ValueError(f"unsupported hparam type {type(ref)} for {value!r}")


@dataclasses.dataclass
class HParams:
    """All knobs of the framework, one flat namespace (reference parity)."""

    # ------------------------------------------------------------------ #
    # Audio frontend (reference: companion tacotron2/util/audio.py + hparams)
    # ------------------------------------------------------------------ #
    sample_rate: int = 22050
    num_mels: int = 80
    num_freq: int = 1025              # linear-spectrogram bins = n_fft//2 + 1
    frame_length_ms: float = 50.0     # STFT window length
    frame_shift_ms: float = 12.5      # STFT hop
    preemphasis: float = 0.97
    min_level_db: float = -100.0
    ref_level_db: float = 20.0
    average_mel_level_db: Tuple[float, ...] = ()  # optional per-bin mean norm
    stddev_mel_level_db: Tuple[float, ...] = ()   # optional per-bin std norm
    silence_mel_level_db: float = -3.0            # inert, reference-name parity (trailing silence handled by trim_top_db at preprocess)
    trim_top_db: float = 60.0         # silence trimming threshold
    trim_frame_length: int = 2048
    trim_hop_length: int = 512
    mel_fmin: float = 0.0
    mel_fmax: float = 0.0             # 0 → sample_rate / 2
    griffin_lim_iters: int = 60
    power: float = 1.5                # spectrogram magnitude power for GL

    # WORLD vocoder feature dims (MgcLf0 model family)
    num_mgcs: int = 60
    num_lf0s: int = 256               # quantized lf0 one-hot size
    mgc_order: int = 59

    # ------------------------------------------------------------------ #
    # Model selection (reference: hparams tacotron_model/encoder/decoder/...)
    # ------------------------------------------------------------------ #
    tacotron_model: str = "DualSourceSelfAttentionTacotronModel"
    encoder: str = "SelfAttentionCBHGEncoder"
    decoder: str = "DualSourceDecoder"
    attention: str = "forward"        # primary attention mechanism
    attention2: str = "additive"      # dual-source second mechanism
    # embeddings
    num_symbols: int = 256
    embedding_dim: int = 256
    # speaker conditioning (VCTK config)
    num_speakers: int = 1
    speaker_embedding_dim: int = 16
    speaker_embedding_offset: int = 0
    use_speaker_embedding: bool = False
    channel_id_to_postnet: bool = False  # feed speaker embed to PostNetV2
    # accentual-type conditioning (Japanese pitch-accent config)
    use_accent_type: bool = False
    num_accent_type: int = 129
    accent_type_embedding_dim: int = 32
    accent_type_offset: int = 0x3100
    accent_type_unknown: int = 0x3137

    # ------------------------------------------------------------------ #
    # Encoder architecture
    # ------------------------------------------------------------------ #
    encoder_prenet_out_units: Tuple[int, ...] = (256, 128)
    encoder_prenet_drop_rate: float = 0.5
    # ZoneoutEncoderV1 (conv prenet + BiZoneoutLSTM)
    encoder_out_units: int = 256      # total over both LSTM directions
    cbhg_out_units: int = 256         # CBHG output (BiGRU 2x128)
    conv_channels: int = 128          # CBHG conv bank channels
    max_filter_width: int = 16        # CBHG conv bank K
    projection1_out_channels: int = 128
    projection2_out_channels: int = 128
    num_highway: int = 4
    # self-attention stream (SelfAttentionCBHGEncoder)
    self_attention_out_units: int = 256
    self_attention_num_heads: int = 2
    self_attention_num_hop: int = 1   # number of stacked self-attention blocks
    self_attention_drop_rate: float = 0.05
    self_attention_transformer_ffn_units: int = 1024

    # ------------------------------------------------------------------ #
    # Decoder architecture
    # ------------------------------------------------------------------ #
    decoder_prenet_out_units: Tuple[int, ...] = (256, 128)
    decoder_prenet_drop_rate: float = 0.5
    attention_out_units: int = 256    # attention-RNN LSTM units
    attention1_out_units: int = 224   # dual-source: primary mechanism dim
    attention2_out_units: int = 32    # dual-source: secondary mechanism dim
    decoder_out_units: int = 256      # each decoder LSTM layer
    decoder_version: str = "v1"       # inert, reference-name parity (decoder selection keys on `decoder`)
    outputs_per_step: int = 2         # reduction factor r
    max_iters: int = 500              # AR decode cap (decoder steps)
    n_feed_frame: int = 1             # last n frames fed back per step
    zoneout_factor_cell: float = 0.1
    zoneout_factor_output: float = 0.1
    decoder_self_attention_out_units: int = 256
    decoder_self_attention_num_heads: int = 2
    decoder_self_attention_num_hop: int = 1
    decoder_self_attention_drop_rate: float = 0.05
    # location-sensitive attention
    attention_kernel: int = 31
    attention_filters: int = 32
    cumulative_weights: bool = True
    # forward attention
    use_forward_attention_transition_agent: bool = False
    # stop token
    stop_token_threshold: float = 0.5

    # ------------------------------------------------------------------ #
    # Post-net
    # ------------------------------------------------------------------ #
    use_postnet_v2: bool = False      # conv-residual mel refinement (T2-style)
    postnet_v2_num_layers: int = 5
    postnet_v2_kernel_size: int = 5
    postnet_v2_out_channels: int = 512
    postnet_v2_drop_rate: float = 0.5
    # CBHG postnet → linear spectrogram (enables Griffin-Lim)
    use_linear_spectrogram_postnet: bool = False

    # ------------------------------------------------------------------ #
    # Loss
    # ------------------------------------------------------------------ #
    spec_loss_type: str = "l1"        # "l1" | "mse"
    use_l2_regularization: bool = False
    l2_regularization_weight: float = 1e-7
    binary_divergence_weight: float = 0.0

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #
    batch_size: int = 32
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    initial_learning_rate: float = 0.0005
    decay_learning_rate: bool = True
    learning_rate_step_factor: int = 1
    gradient_clip_norm: float = 1.0
    use_gradient_clipping: bool = False
    save_summary_steps: int = 100          # scalar-summary write cadence
    save_checkpoints_steps: int = 500
    keep_checkpoint_max: int = 200
    keep_checkpoint_every_n_hours: int = 1  # checkpoints on this grid survive eviction
    log_step_count_steps: int = 1
    alignment_save_steps: int = 10000      # training-cadence alignment/mel PNGs
    save_training_time_metrics: bool = False  # log steps/sec + frames/sec
    num_evaluation_steps: int = 64
    eval_start_delay_secs: int = 120       # no eval before this much train time
    eval_throttle_secs: int = 600          # min seconds between evals
    random_seed: int = 1234

    # input pipeline. The pipeline quantizes lengths to static bucket
    # shapes and full-epoch shuffles in memory, so the tf.data boundary-
    # estimation and streaming-shuffle knobs below are inert (kept for
    # reference-name parity); the active knobs are batch_bucket_width,
    # prefetch_buffer_size, use_cache and cache_file_name.
    approx_min_target_length: int = 100  # inert: static bucket quantization needs no boundary estimate
    batch_bucket_width: int = 50
    batch_num_buckets: int = 50       # inert: bucket count follows from data/width, not a cap
    suffle_buffer_size: int = 64      # [sic] reference spelling; inert: full-epoch shuffle is stronger
    interleave_cycle_length_cpu_factor: float = 1.0  # inert: no file interleaving (direct per-utterance reads)
    interleave_cycle_length_min: int = 4             # inert: see above
    interleave_cycle_length_max: int = 16            # inert: see above
    interleave_buffer_output_elements: int = 200     # inert: see above
    interleave_prefetch_input_elements: int = 200    # inert: see above
    prefetch_buffer_size: int = 4     # host prefetch-thread queue depth
    use_cache: bool = False           # in-memory parsed-utterance cache
    cache_file_name: str = ""         # + persist/load it as one pickle file
    dataset: str = "ljspeech"
    source_file_extension: str = "source.tfrecord"
    target_file_extension: str = "target.tfrecord"

    # ------------------------------------------------------------------ #
    # Prediction / synthesis
    # ------------------------------------------------------------------ #
    use_forced_alignment_mode: bool = False
    predicted_mel_extension: str = "mfbsp"

    # ------------------------------------------------------------------ #
    # Logging
    # ------------------------------------------------------------------ #
    logfile: str = "log.txt"

    # ------------------------------------------------------------------ #
    # Additions with no counterpart in the reference hparams
    # ------------------------------------------------------------------ #
    compute_dtype: str = "float32"    # "float32" | "bfloat16" matmul dtype
    mesh_shape: Tuple[int, ...] = ()  # () → all devices on one 'data' axis
    mesh_axis_names: Tuple[str, ...] = ("data", "model")
    use_pallas_kernels: bool = True   # hand-written kernels where a module has one (name kept from the JAX package)

    # ------------------------------------------------------------------ #

    def parse(self, overrides: Optional[str]) -> "HParams":
        """Apply ``key=value,key=value`` overrides (reference CLI semantics).

        Tuple values use ``+`` as the element separator (commas split
        top-level pairs), e.g. ``decoder_prenet_out_units=256+128``.
        """
        if not overrides:
            return self
        for pair in overrides.split(","):
            pair = pair.strip()
            if not pair:
                continue
            if "=" not in pair:
                raise ValueError(f"malformed hparam override {pair!r}")
            key, value = pair.split("=", 1)
            key = key.strip()
            if not hasattr(self, key):
                raise ValueError(f"unknown hparam {key!r}")
            setattr(self, key, _coerce(value.strip(), getattr(self, key)))
        return self

    def override_from_json_file(self, path: str) -> "HParams":
        with open(path, "r") as f:
            return self.override_from_dict(json.load(f))

    def override_from_dict(self, values: dict) -> "HParams":
        for key, value in values.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown hparam {key!r}")
            if isinstance(value, list):
                value = tuple(value)
            setattr(self, key, value)
        return self

    def values(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.values(), indent=2, sort_keys=True)

    # Derived quantities -------------------------------------------------

    @property
    def n_fft(self) -> int:
        return (self.num_freq - 1) * 2

    @property
    def win_length(self) -> int:
        return int(self.frame_length_ms / 1000.0 * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.frame_shift_ms / 1000.0 * self.sample_rate)

    @property
    def fmax(self) -> float:
        return self.mel_fmax if self.mel_fmax > 0 else self.sample_rate / 2.0


def default_hparams() -> HParams:
    return HParams()
