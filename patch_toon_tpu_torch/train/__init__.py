"""GAN training of the port (counterpart of patch_toon_tpu/train)."""
