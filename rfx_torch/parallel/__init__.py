from .dist import (
    initialize_multihost,
    make_mesh,
    sharded_cir,
    sharded_coverage_irs,
)

__all__ = [
    "initialize_multihost",
    "make_mesh",
    "sharded_cir",
    "sharded_coverage_irs",
]
