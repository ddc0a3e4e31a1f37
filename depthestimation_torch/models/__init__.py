"""The monocular depth net (ViT encoder + DPT head) and its weights."""
