"""The Transformer LM training example's twin."""
