"""Command-line entry points of the port (``python -m audio_suite_torch.cli``)."""
