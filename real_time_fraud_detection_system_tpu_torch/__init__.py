"""PyTorch/CUDA port of the real-time fraud detection serving path.

A second package beside the JAX one (which stays the reference): the same
module paths and public names, plain functions on tensors, and hand-written
Hopper kernels under ``csrc/``. Entry points take ``device=None``, which
means CUDA; only an explicit ``device="cpu"`` runs on the CPU, where every
kernel wrapper runs its plain PyTorch version.
"""

from real_time_fraud_detection_system_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
