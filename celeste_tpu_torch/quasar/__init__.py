"""Quasar SED photo-z (counterpart of ``celeste_tpu/quasar``; BASELINE
config 4): a nonnegative rest-frame SED basis, its projection through
broadband filter curves, and a tempered sampler over the multimodal
redshift posterior, batch-major (the ladder, the systems and the targets
are axes of one chain batch)."""

from celeste_tpu_torch.quasar.filters import FilterBank, sdss_like_filterbank  # noqa: F401
from celeste_tpu_torch.quasar.basis import (  # noqa: F401
    QuasarBasis,
    fit_basis,
    synthetic_quasar_spectra,
    synthetic_template_basis,
)
from celeste_tpu_torch.quasar.photometry import (  # noqa: F401
    BandMatrixGrid,
    band_matrix_grid,
    basis_band_matrix,
    project_to_bands,
    project_to_bands_grid,
)
from celeste_tpu_torch.quasar.photo_z import (  # noqa: F401
    PhotoZConfig,
    make_photo_z_logdensity,
    run_photo_z,
    run_photo_z_batch,
    run_photo_z_batch_segmented,
    run_photo_z_sharded,
)
