"""Controllers: free-final-time trajectories and the CBF filter."""
