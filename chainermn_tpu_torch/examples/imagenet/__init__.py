"""The ImageNet (ResNet) training example's twin."""
