"""Training: losses, data, augmentation, optimizers and train steps, and
the two trainers (``train_unet``, ``train_classifier``)."""
