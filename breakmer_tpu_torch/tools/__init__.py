"""The TPU probes of ``tools/`` ported to the card: each holds a
hand-written CUDA kernel (``csrc/``) beside its plain torch version and
runs as ``python -m breakmer_tpu_torch.tools.<probe>`` on a card."""
