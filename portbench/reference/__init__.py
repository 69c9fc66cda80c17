"""The benchmark's plain PyTorch reference of the inpainting model: the
networks (nets.py) and the two-stage inference and GAN train step
(step.py).  It imports nothing of the program under test."""
