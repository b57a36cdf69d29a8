"""Min-plus (tropical) products and the blocked Floyd-Warshall APSP:
CUDA kernels (``kernel``), plain twins (``ref``), entry points (``ops``)."""
