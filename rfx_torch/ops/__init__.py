"""Intersection primitives, BVH packing and the kernel wrappers."""
