"""Model zoo of the port (dense decoders and Mamba2 in this slice)."""
