"""The Paddle tensor, its autograd over torch's and the op dispatch."""
