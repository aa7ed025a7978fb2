"""Measurement rigs of the port's kernels on the card, each run as
``python -m maest_tpu_torch.probes.<rig>``: ``attn_profile`` splits the
bf16 attention forward's time between its parts."""
