"""Synthetic test images: the package's seeded numpy generator."""

from cascadeclassifier_tpu.data.synth import face_blob_image  # noqa: F401
