"""The harness: what every cell shares (the cell's files, the closed-loop
driver, the device trace, the statistics, the result line)."""
