"""The model substrate: the Mamba-2 (``ssm``) and Zamba2 (``hybrid``)
families, their layers and their decode caches."""
