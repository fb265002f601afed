"""In-model resize and fused upsample+conv of the PyTorch port."""
