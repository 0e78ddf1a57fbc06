"""QC artifacts of a run: the error profile, the filter logs and CSVs, the
stage timing table and the cross-region UMI audit."""
