"""NN substrate of the port: the DiT and the layers it reaches."""
