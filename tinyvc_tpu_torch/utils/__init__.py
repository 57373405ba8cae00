"""Weight transfer and audio file I/O."""
