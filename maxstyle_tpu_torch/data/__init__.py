"""On-device batched data augmentation."""
