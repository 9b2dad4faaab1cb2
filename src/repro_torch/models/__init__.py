"""Model zoo of the port (the audio enc-dec family so far)."""
