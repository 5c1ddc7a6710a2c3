"""Data model and render orchestration."""
