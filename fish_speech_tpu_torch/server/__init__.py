"""OpenAI-compatible HTTP serving: the request logic in `core` (no
aiohttp), the aiohttp layer in `app`, the entry point in `main`."""
