"""The hand-written Hopper kernels (``csrc/``), their wrappers and plain
versions: the FTP kernels (`ftp_spmm`), flash attention (`flash_mha`), the
load-time join plans and the policy front door (`ops`)."""
