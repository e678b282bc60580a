"""Model zoo of the port (dense decoders in this slice)."""
