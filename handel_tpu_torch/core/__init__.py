"""The protocol plane: Handel, its store, pipeline, partitioner, packets and in-process harness."""
