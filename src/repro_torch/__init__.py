"""The PyTorch/CUDA port of CoServe (see README.md, "PyTorch port")."""
