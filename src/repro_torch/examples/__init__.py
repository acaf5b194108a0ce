"""Runnable examples of the port, as modules:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.stream_equalizer [--device cpu]
"""
