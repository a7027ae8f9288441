"""euler_tpu_torch — the PyTorch + CUDA port of euler_tpu.

The JAX package (`euler_tpu/`) is the reference this port is held
against.  The port runs the bundled text scenarios and the presets on
one NVIDIA Hopper card behind the same CLI (`python -m euler_tpu_torch`):
slot markers marched and re-binned, sources emitted, the grid stage and
the projection, each as hand-written CUDA launches.  On CPU tensors every
kernel wrapper takes its plain PyTorch version instead (the CPU tests
compare those with the JAX package).  This module imports nothing heavy:
import `euler_tpu_torch.sim` for the frame loop.
"""

__version__ = "0.1.0"
