"""Host pieces the port needs: bitset, scheme interfaces, validation counters."""
