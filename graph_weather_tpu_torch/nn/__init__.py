"""Message-passing building blocks."""
