"""FTP kernels: the hand-written Hopper kernel, its wrapper and plain
version, the load-time join plans and the policy front door."""
