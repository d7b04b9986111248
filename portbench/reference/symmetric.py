"""The plain reference of the symmetric cones (zero, nonnegative,
second-order, PSD), named by a configuration's "reference" key:
`measures`, the certificate of returned answers, and `solve`, the
interior-point method that solves one problem again."""

from .certificate import measures  # noqa: F401
from .ipm import solve  # noqa: F401
