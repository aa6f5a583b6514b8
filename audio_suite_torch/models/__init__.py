"""Render engines of the port (one module per engine of audio_suite_tpu)."""
