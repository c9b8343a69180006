"""The MNIST training example's twin."""
