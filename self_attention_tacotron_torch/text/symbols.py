"""English grapheme symbol inventory (keithito-derived convention).

The port's own copy of the JAX package's ``text/symbols.py``. Symbol 0 is
padding, symbol 1 is EOS (``~``), as in the keithito Tacotron lineage.
"""

_pad = "_"
_eos = "~"
_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'\"(),-.:;? "

symbols = [_pad, _eos] + list(_characters)

PAD_ID = 0
EOS_ID = 1

symbol_to_id = {s: i for i, s in enumerate(symbols)}
id_to_symbol = {i: s for i, s in enumerate(symbols)}
