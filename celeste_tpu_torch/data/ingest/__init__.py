"""Offline host-side ingest (counterpart of ``celeste_tpu/data/ingest``):
FITS parsing, SDSS frame -> photon-count stamps, PSF fitting.  NumPy on the
host; only ``frame_to_stamp``'s finished stamp goes to a torch device.
``fits_lite`` implements the subset of FITS needed for SDSS frame files."""

from celeste_tpu_torch.data.ingest.fits_lite import read_fits, write_fits_image, write_fits_table  # noqa: F401
from celeste_tpu_torch.data.ingest.sdss import frame_to_stamp, TanWcs  # noqa: F401
