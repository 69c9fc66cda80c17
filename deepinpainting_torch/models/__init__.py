"""The three inference networks: VGG16 slices, netP and netG."""
