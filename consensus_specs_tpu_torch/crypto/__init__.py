"""Host-side BLS12-381 bignum arithmetic of the port (staging only)."""
