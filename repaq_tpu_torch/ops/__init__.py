"""Device operations: CUDA kernels and the stream coders."""

# device_streams hands kernels the emission's plain versions, which sit
# above it, when imported
from . import device_streams  # noqa: F401
