"""The plain reference the benchmark holds the port's outputs against.

Plain PyTorch over the harness's own scene description (raw world
triangles, material records, rect lights, the camera): it imports nothing
of the port and reads no table the port built. Its counter-based RNG, its
camera and its shading are frozen copies of the semantics the port
documents, so that on the same seed both trace the same sample set ray for
ray; its traversal is a brute-force Moller-Trumbore over the triangles,
culled by the boxes of consecutive runs of them.
"""
