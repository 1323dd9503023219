"""Host utilities: kernel builds, artifact writers, throughput."""
