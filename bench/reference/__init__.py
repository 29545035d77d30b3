"""The plain reference of the benchmark's cells: plain torch, no kernel, no
part of the program under test."""
