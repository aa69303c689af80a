"""Cell-grid neighbour sweeps (CUDA kernels) and the O(N²) oracle."""
