"""K-sample ADE/FDE evaluation."""
