"""stereo_tpu — a 3D-label stereo reconstruction engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
johannesu/stereo (CVPR'13 "In Defense of 3D-Label Stereo" and EMMCVPR'13
"Simultaneous Fusion Moves for 3D-Label Stereo"): plane-label MRF stereo with
truncated second-order smoothness, optimized by binary fusion moves (roof
duality) and simultaneous multi-proposal fusion (TRW-S message passing) — all
expressed as dense array programs over the pixel grid, sharded across
device meshes with halo exchange.
"""

__version__ = "0.1.0"

from stereo_tpu import config, energy, geometry  # noqa: F401


def __getattr__(name):
    # lazy top-level API (avoids importing jax-heavy modules at package import)
    if name in ("DispMap", "DispMapNCC", "DispMapGlobalStereo"):
        from stereo_tpu import models

        return getattr(models, name)
    if name == "SecondOrderStereo":
        from stereo_tpu.models.second_order import SecondOrderStereo

        return SecondOrderStereo
    if name == "solvers":
        from stereo_tpu import solvers

        return solvers
    raise AttributeError(name)
