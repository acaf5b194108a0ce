"""Simulated channels (port of `repro.channels`): IM/DD and Proakis-B,
stationary and drifting (`drift`: tap rotation, fiber length and SNR
ramps over a burst schedule).
"""
from . import common, drift, imdd, proakis
from .common import awgn, ber, ber_from_soft, bits_to_pam, pam_decision
from .drift import DriftingIMDD, DriftingProakis, DriftSchedule
from .imdd import IMDDConfig
from .proakis import ProakisConfig

__all__ = ["common", "drift", "imdd", "proakis", "DriftingIMDD",
           "DriftingProakis", "DriftSchedule", "awgn", "ber", "ber_from_soft",
           "bits_to_pam", "pam_decision", "IMDDConfig", "ProakisConfig"]
