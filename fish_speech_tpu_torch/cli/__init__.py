"""Command-line tools of the port: llama_generate, vocoder, encoder."""
