"""Text front end: cleaning, chunking and ChatML prompt assembly."""
