"""Simulated channels (port of `repro.channels`): IM/DD and Proakis-B.

`channels/drift.py` (drifting operating points) is not ported yet.
"""
from . import common, imdd, proakis
from .common import awgn, ber, ber_from_soft, bits_to_pam, pam_decision
from .imdd import IMDDConfig
from .proakis import ProakisConfig

__all__ = ["common", "imdd", "proakis", "awgn", "ber", "ber_from_soft",
           "bits_to_pam", "pam_decision", "IMDDConfig", "ProakisConfig"]
