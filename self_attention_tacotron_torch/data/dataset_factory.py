"""Corpus name -> recipe mapping.

The port's own copy of the JAX package's ``data/dataset_factory.py``: maps
``hparams.dataset`` / the CLI ``--dataset`` flag to the preprocessor class; the
online pipeline is corpus-independent (:class:`...data.dataset.TacotronDataset`).
"""

from __future__ import annotations

from self_attention_tacotron_torch.data.japanese import JapanesePitchAccent
from self_attention_tacotron_torch.data.ljspeech import LJSpeech
from self_attention_tacotron_torch.data.synthetic import SyntheticCorpus
from self_attention_tacotron_torch.data.vctk import VCTK

_CORPORA = {
    "ljspeech": LJSpeech,
    "vctk": VCTK,
    "japanese": JapanesePitchAccent,
    "jsut": JapanesePitchAccent,
    "synthetic": SyntheticCorpus,
}


def dataset_factory(name: str):
    try:
        return _CORPORA[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown dataset {name!r}; known: {sorted(_CORPORA)}"
        ) from None
