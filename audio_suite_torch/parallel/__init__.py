"""The parallel layer of the port (audio_suite_tpu/parallel/): device meshes,
sharded batch renders and collectives, the sharded timeline and CA, the
multi-process dispatch and the multi-device dry run."""
