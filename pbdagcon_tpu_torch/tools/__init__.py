"""Measurement tools of the port, each run as `python -m
pbdagcon_tpu_torch.tools.<name>`: `prof_pk`, the kernel-variant
microbench."""
