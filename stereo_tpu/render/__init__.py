"""New-view-synthesis toolbox (the reference's imrender/ojw renderers).

Array-program equivalents of the bundled IBR pipeline:

- :mod:`stereo_tpu.render.genview`   — output-view projection matrices
  (ojw_genview.m, P2stereoP.m, P_interp.m);
- :mod:`stereo_tpu.render.modes`     — truncated-quadratic colour modes
  (truncquad_modes.cxx) as a dense fixed-capacity device program;
- :mod:`stereo_tpu.render.edges`     — pairwise dictionary edge costs
  (truncquad_edges.cxx) as dense min-plus;
- :mod:`stereo_tpu.render.edgemodes` — the CVPR'07 "Pairwise Dictionary
  Priors" renderer (ibr_edgemodes.m) on the TRW/BP table solver;
- :mod:`stereo_tpu.render.occlrender` — the BMVC'07 occlusion-aware
  renderer (ibr_occlrender.m) on QPBO fusion with geometric visibility.
"""

from stereo_tpu.render.genview import genview, stereo_views, interp_views  # noqa: F401
from stereo_tpu.render.occlrender import (  # noqa: F401
    OcclRenderOptions,
    render_occl,
)
