"""The paper's equalizer operating points (the LM configs are not ported)."""
from . import equalizer_ht, equalizer_lp

__all__ = ["equalizer_ht", "equalizer_lp"]
