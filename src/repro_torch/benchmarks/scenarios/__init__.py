"""The six replayable traffic scenarios (JSON specs) and their runner."""
