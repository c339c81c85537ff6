% test_inversa_mat.m — MATLAB consumer of the native inversion library.
%
% The analog of the reference's FP32_matlab_version/test_inversa_mat.mlx
% (workflow at the reference README.md:25-57): where the reference imports
% its Windows static library via clibgen, this script loads the Linux shared
% library via loadlibrary/calllib against native/matinv.h.
%
% Prerequisites (run once, from the repo root):
%   make -C native
%   export PYTHONPATH=<site-packages>:$PWD
%   (start MATLAB from that shell so the embedded interpreter finds JAX)
%
% This file cannot execute in this repo's CI (no MATLAB); it is kept
% syntactically complete and is what a MATLAB user runs verbatim.

here = fileparts(mfilename('fullpath'));
lib = fullfile(here, 'build', 'libmatinv_tpu');
hdr = fullfile(here, 'matinv.h');

if ~libisloaded('libmatinv_tpu')
    loadlibrary(lib, hdr);
end

% Optional eager init (first call otherwise pays the JAX startup).
rc = calllib('libmatinv_tpu', 'matinv_tpu_init');
assert(rc == 0, 'matinv_tpu_init failed: %d', rc);

% Hollow random test matrix — the reference protocol (main_file.cpp:41-52):
% uniform(0,100) off-diagonal, exact zeros on the diagonal.
n = 256;
rng(5);
A = single(rand(n) * 100);
A(1:n+1:end) = 0;

% Row-major flat vector in/out (MATLAB stores column-major: pass A' and
% transpose the result back).
inPtr  = libpointer('singlePtr', reshape(A', [], 1));
outPtr = libpointer('singlePtr', zeros(n * n, 1, 'single'));
rc = calllib('libmatinv_tpu', 'matrix_inv_32', inPtr, n, outPtr);
assert(rc == 0, 'matrix_inv_32 failed: %d (1 = invalid/singular)', rc);
Ainv = reshape(outPtr.Value, n, n)';

% Residual gate — the reference's matrix_multiply check
% (matrix_multiply.cpp:193-204), done properly: ||A*Ainv - I||_F scaled.
resid = norm(double(A) * double(Ainv) - eye(n), 'fro') / ...
        (norm(double(A), 'fro') * norm(double(Ainv), 'fro'));
fprintf('n=%d relative residual = %.3e\n', n, resid);
assert(resid < 1e-5, 'residual too large');

% Failure contract: a singular (all-ones) matrix must return rc == 1
% (the reference returns an empty vector, README.md:53-54).
S = ones(8, 'single');
sPtr = libpointer('singlePtr', reshape(S', [], 1));
oPtr = libpointer('singlePtr', zeros(64, 1, 'single'));
rc = calllib('libmatinv_tpu', 'matrix_inv_32', sPtr, 8, oPtr);
assert(rc == 1, 'singular matrix must report rc == 1, got %d', rc);

% Solve path (no reference analog — an extra of this library): A x = b.
k = 4;
b = single(randn(n, k));
bPtr = libpointer('singlePtr', reshape(b', [], 1));
xPtr = libpointer('singlePtr', zeros(n * k, 1, 'single'));
rc = calllib('libmatinv_tpu', 'matrix_solve_32', inPtr, bPtr, n, k, xPtr);
assert(rc == 0, 'matrix_solve_32 failed: %d', rc);
x = reshape(xPtr.Value, k, n)';
fprintf('solve residual = %.3e\n', norm(double(A) * double(x) - double(b)));

unloadlibrary('libmatinv_tpu');
disp('test_inversa_mat: all checks passed');
